"""The check of the Granite-4.0-H caption kind (``kinds/caption_granite.py``)
on a tiny cell on the CPU, as ``test_kimi_check.py`` holds the Kimi-Linear
kind: a sound run comes out correct; the control (the reference in float8
in the program's place) reads above a limit; a batch answered for the
wrong images, a token altered, or beams that continue their own Mamba
state and window instead of their parent's (no reorder) come out not
correct.  The tiny cell takes ``tiny_granite.json``: every mechanism of
the model, the Mamba heads at their published widths (64, a state of 128)
in a 256-wide model, 4 of 8 experts held; and ``conftest.TINY_LIMITS``'
caption limits but for ``score_err`` and ``rank_gap`` (``LIMITS``)."""
import json
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from conftest import HERE, TINY_LIMITS, TINY_TRAFFIC

from clipcap_tpu_torch.encoders import clip as clip_mod
from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.models import granite_hybrid as gh

from portbench import harness
from portbench.kinds import caption_granite
from portbench.traffic import generate

CELL = "caption.vitl14-granite4h-small.b64"
NEW = ("mamba_decode_roofline", "mamba.state_share", "mfu.caption_granite")
# The published logits ÷ 16 leave a tiny model's log-probabilities within
# ~0.01 of uniform, so its score errors are ~20× smaller than the GPT-2
# tiny cell's.  Set as the tiny cells' are (14 sound seeds, 3 each of the
# control and the no-reorder fault, on the CPU): score_err sound max
# 0.00062, control min 0.00123, fault min 0.00128 → 0.0009; rank_gap sound
# 0 on every seed, control min 0.0026 → 0.001.
LIMITS = dict(TINY_LIMITS["caption"], score_err=0.0009, rank_gap=0.001)


def _files() -> SimpleNamespace:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    real = harness.cell_files(bench, CELL)
    _, cut = TINY_TRAFFIC["caption"]
    spec = dict(real.spec, limits=LIMITS, check_images=4)
    return SimpleNamespace(entry={"name": "tiny.caption_granite", "chips": 1},
                           cfg=json.loads((HERE / "tiny_granite.json").read_text()),
                           traffic=dict(generate.load("caption_granite.b64"), **cut), spec=spec,
                           kind=caption_granite)


def _run(seed: int = 123456789012) -> dict:
    args = SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    return harness.run_cell(_files(), {"end_to_end": [], "per_layer": []}, args,
                            torch.device("cpu"), 0.0)


def test_cell_names_the_kind():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    assert harness.cell_files(bench, CELL).kind is caption_granite


def test_seeded_weights_fit_the_model():
    """Every key the port's module has, and no other, at the tiny size."""
    cfg = _files().cfg
    lm = caption_granite.language_model(cfg, 5, torch.device("cpu"), torch.float32)
    assert isinstance(lm, gh.GraniteHybrid)
    assert lm.config.routing.n_experts == 8 and lm.config.experts_held == (2, 6)


def test_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]


def test_control_fails_a_limit():
    files = _files()
    cell = files.kind.Cell(files.cfg, files.traffic, files.spec, 987654321, torch.device("cpu"))
    cell.warmup()
    harness.window(cell, 0.0)
    cell.release()
    readings = cell.readings(modes=("fp32", "fp8"))
    over = {k: readings[f"ctrl.{k}"] for k, limit in files.spec["limits"].items()
            if readings[f"ctrl.{k}"] > limit}
    assert over, {k: readings[f"ctrl.{k}"] for k in files.spec["limits"]}


def _wrong_images(orig):
    def __call__(self, batch):
        return orig(self, batch)[::-1].copy()
    return __call__


def _altered_tokens(orig):
    def beam_search_batched(*args, **kwargs):
        res = orig(*args, **kwargs)
        tokens = res.tokens.clone()
        tokens[..., 2] = (tokens[..., 2] + 1) % 500
        return res._replace(tokens=tokens)
    return beam_search_batched


def _no_reorder(orig):
    def own_rows(ancestry, beam_size, cache_index, cache_base):
        if cache_index == cache_base:
            return orig(ancestry, beam_size, cache_index, cache_base)
        return torch.arange(ancestry.shape[0], dtype=torch.int32, device=ancestry.device)
    return own_rows


@pytest.mark.parametrize("owner,attr,make", [
    (clip_mod.CLIPEncoder, "__call__", _wrong_images),
    (beam_mod, "beam_search_batched", _altered_tokens),
    (gh, "beam_parent", _no_reorder),
], ids=["wrong_images", "token_altered", "no_reorder"])
def test_broken_path_is_not_correct(owner, attr, make):
    with mock.patch.object(owner, attr, make(getattr(owner, attr))):
        result = _run()
    assert result["correct"] is False, result["checks"]


def test_state_share_reads_its_span():
    from test_program_spans import FakeTrace

    host = [(10, 50, "beam.prefill"), (20, 30, "mamba.prefill"), (100, 200, "beam.step"),
            (150, 160, "mamba.decode")]
    device = [(1000, 5000, "prefill", 12), (5000, 5200, "prefill mamba", 25),
              (7000, 8000, "step", 120), (8000, 8500, "inside", 155)]

    def ctx(kind="caption", host=host):
        tr = FakeTrace(host, device)
        return SimpleNamespace(work={"kind": kind, "units": 1}, range_s=tr.range_s, busy_s=0.01)

    mod = harness.metric_module("mamba.state_share")
    assert mod.read(ctx()) == pytest.approx(100 * 500e-6 / 0.01)
    assert mod.read(ctx(host=[h for h in host if h[2] != "mamba.decode"])) is None
    assert mod.read(ctx(kind="train")) is None


def test_new_metrics_match_their_entries():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for name in NEW:
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        mod = harness.metric_module(name)
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
        assert entry["workloads"] == [CELL]


def test_the_cell_is_off_the_expert_roofline():
    """``moe_experts_roofline`` counts a call's rows from its shape, which a
    share of 9 of 72 experts fills to ~12% (PERF.md §7)."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == "moe_experts_roofline")
    assert CELL not in entry["workloads"]


def test_roofline_counts_each_parent_once():
    """Five beams on one parent read its state and window once; a fresh row
    reads none."""
    mod = harness.metric_module("mamba_decode_roofline")
    B, H, Pm, Nm = 10, 2, 64, 128
    C = H * Pm + 2 * Nm
    xbc = torch.zeros(B, C, dtype=torch.bfloat16)
    dt = torch.zeros(B, H, dtype=torch.bfloat16)
    s = torch.zeros(B, H, Pm, Nm, dtype=torch.bfloat16)
    w = torch.zeros(B, 3, C, dtype=torch.bfloat16)
    parents = torch.tensor([3, 3, 3, 3, 3, -1, 6, 7, 7, 9], dtype=torch.int32)
    call = mod.facts(xbc, dt, None, None, None, None, None, parents, w, w, s, s)
    nbytes, ops, dtype = list(call)
    assert int(call.parents) == 4
    assert nbytes == call.fixed + 4 * call.per_parent
    assert call.per_parent == H * Pm * Nm * 2 + 3 * C * 2
    assert ops == 5 * B * H * Pm * Nm and dtype == "float32"


def test_flops_count_the_published_layers():
    """40 layers' projections, the recurrence, attention over its keys and
    the tied head at the cell's configuration."""
    from portbench import flops_granite

    cfg = harness.load_json(harness.ROOT / "portbench/configs/vitl14-granite4h-small.json")
    per_row = flops_granite.positions(cfg, 1, 0, 0)
    mamba = 2 * 4096 * 16768 + 2 * 8192 * 4096 + 8 * 8448 + 5 * 128 * 64 * 128
    attention = 2 * 4096 * 48 * 128 + 2 * 4096 * 4096
    moe = 2 * 4096 * 72 + 6 * 4096 * 1536
    assert per_row == 36 * mamba + 4 * attention + 40 * moe
    assert flops_granite.positions(cfg, 0, 1, 0) == 4 * 4 * 32 * 128
    assert flops_granite.positions(cfg, 0, 0, 1) == 2 * 4096 * 100352
