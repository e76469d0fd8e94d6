"""The check of the Kimi-Linear caption kind (``kinds/caption_kimi.py``) on a
tiny cell on the CPU, as ``test_dsv2_check.py`` holds the DeepSeek-V2 kind:
a sound run comes out correct; the control (the reference in float8 in the
program's place) reads above a limit; a batch answered for the wrong
images, a token altered, or beams that continue their own recurrent state
instead of their parent's (no reorder) come out not correct.  The tiny
cell takes ``conftest.TINY_LIMITS``' caption limits and ``tiny_kimi.json``:
every mechanism of the model at tiny widths, 4 of 8 experts held."""
import json
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from conftest import HERE, TINY_LIMITS, TINY_TRAFFIC

from clipcap_tpu_torch.encoders import clip as clip_mod
from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.models import kimi_linear as km
from clipcap_tpu_torch.models.decoding import beam_parent

from portbench import harness
from portbench.kinds import caption_kimi
from portbench.traffic import generate

CELL = "caption.vitl14-kimilinear.b96"


def _files() -> SimpleNamespace:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    real = harness.cell_files(bench, CELL)
    _, cut = TINY_TRAFFIC["caption"]
    spec = dict(real.spec, limits=TINY_LIMITS["caption"], check_images=4)
    return SimpleNamespace(entry={"name": "tiny.caption_kimi", "chips": 1},
                           cfg=json.loads((HERE / "tiny_kimi.json").read_text()),
                           traffic=dict(generate.load("caption_kimi.b96"), **cut), spec=spec,
                           kind=caption_kimi)


def _run(seed: int = 123456789012) -> dict:
    args = SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    return harness.run_cell(_files(), {"end_to_end": [], "per_layer": []}, args,
                            torch.device("cpu"), 0.0)


def test_cell_names_the_kind():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    assert harness.cell_files(bench, CELL).kind is caption_kimi


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
    (km, "beam_parent", _no_reorder),
], ids=["wrong_images", "token_altered", "no_reorder"])
def test_broken_path_is_not_correct(owner, attr, make):
    with mock.patch.object(owner, attr, make(getattr(owner, attr))):
        result = _run()
    assert result["correct"] is False, result["checks"]


def test_the_no_reorder_fault_keeps_the_first_step():
    """The fault's first step reads the prefill's rows, as the sound path."""
    ancestry = torch.zeros(6, 4, dtype=torch.long)
    assert torch.equal(_no_reorder(beam_parent)(ancestry, 3, 4, 4), beam_parent(ancestry, 3, 4, 4))


def test_state_share_reads_its_span():
    from test_program_spans import FakeTrace

    host = [(10, 50, "beam.prefill"), (20, 30, "kda.prefill"), (100, 200, "beam.step"),
            (150, 160, "kda.decode")]
    device = [(1000, 5000, "prefill", 12), (5000, 5200, "prefill kda", 25),
              (7000, 8000, "step", 120), (8000, 8500, "inside", 155)]

    def ctx(kind="caption", host=host):
        tr = FakeTrace(host, device)
        return SimpleNamespace(work={"kind": kind, "units": 1}, range_s=tr.range_s, busy_s=0.01)

    mod = harness.metric_module("kda.state_share")
    assert mod.read(ctx()) == pytest.approx(100 * 500e-6 / 0.01)
    assert mod.read(ctx(host=[h for h in host if h[2] != "kda.decode"])) is None
    assert mod.read(ctx(kind="train")) is None


def test_new_metrics_match_their_entries():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for name in ("kda_decode_roofline", "kda.state_share", "mfu.caption_kimi"):
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        mod = harness.metric_module(name)
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
        assert entry["workloads"] == [CELL]


def test_roofline_counts_each_parent_once():
    """Five beams on one parent read its state once; a fresh row reads none."""
    mod = harness.metric_module("kda_decode_roofline")
    B, H, d = 10, 2, 128
    q = torch.zeros(B, H * d, dtype=torch.bfloat16)
    g = torch.zeros(B, H, d)
    s = torch.zeros(B, H, d, d)
    parents = torch.tensor([3, 3, 3, 3, 3, -1, 6, 7, 7, 9], dtype=torch.int32)
    call = mod.facts(q, q, q, None, None, None, g, None, parents, None, None, s, s)
    nbytes, ops, dtype = list(call)
    assert int(call.parents) == 4
    assert nbytes == call.fixed + 4 * call.per_parent
    assert ops == 7 * B * H * d * d and dtype == "float32"
