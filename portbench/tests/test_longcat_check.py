"""The check of the LongCat-Flash caption kind (``kinds/caption_longcat.py``)
on a tiny cell on the CPU, as ``test_granite_check.py`` holds the
Granite-4.0-H kind: a sound run comes out correct; the control (the
reference in float8 in the program's place) reads above a limit; a batch
answered for the wrong images, a token altered, or the identity experts'
part left out of the shortcut branch come out not correct.  The tiny cell
takes ``tiny_longcat.json``: every mechanism of the model (two double
layers, the query LoRA and both scales, 4 of 8 FFN experts held beside 4
identity experts, top-3, the biased softmax router) in a 128-wide model;
and ``LIMITS``.  The card test holds the grouped expert calls of a
full-width search to one a double layer a forward."""
import json
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from conftest import HERE, TINY_LIMITS, TINY_TRAFFIC

from clipcap_tpu_torch.encoders import clip as clip_mod
from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.models import deepseek_v2 as dsv2
from clipcap_tpu_torch.models import longcat_flash as lc

from portbench import harness
from portbench.kinds import caption_longcat
from portbench.traffic import generate

CELL = "caption.vitl14-longcat-flash.b128"
NEW = ("mfu.caption_longcat", "moe.zero_share")
LIMITS = dict(TINY_LIMITS["caption"])


def _files() -> SimpleNamespace:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    real = harness.cell_files(bench, CELL)
    _, cut = TINY_TRAFFIC["caption"]
    spec = dict(real.spec, limits=LIMITS, check_images=4)
    return SimpleNamespace(entry={"name": "tiny.caption_longcat", "chips": 1},
                           cfg=json.loads((HERE / "tiny_longcat.json").read_text()),
                           traffic=dict(generate.load("caption_longcat.b128"), **cut), spec=spec,
                           kind=caption_longcat)


def _run(seed: int = 123456789012) -> dict:
    args = SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    return harness.run_cell(_files(), {"end_to_end": [], "per_layer": []}, args,
                            torch.device("cpu"), 0.0)


def test_cell_names_the_kind():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    assert harness.cell_files(bench, CELL).kind is caption_longcat


def test_seeded_weights_fit_the_model():
    """Every key the port's module has, and no other, at the tiny size; the
    router over all FFN and identity experts, the selection bias drawn."""
    cfg = _files().cfg
    lm = caption_longcat.language_model(cfg, 5, torch.device("cpu"), torch.float32)
    assert isinstance(lm, lc.LongcatFlash)
    r = lm.config.routing
    assert (r.n_experts, r.zero_experts, r.held) == (8, 4, (2, 6))
    bias = lm.model.layers[0].mlp.router.e_score_correction_bias
    assert bias.shape == (12,) and 0 < float(bias.std()) < 0.05


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


def _without_identity(orig):
    def _combine(y, offsets, inv, w, cfg, rows=None):
        return orig(y, offsets, inv, w, cfg, None if rows is None else torch.zeros_like(rows))
    return _combine


@pytest.mark.parametrize("owner,attr,make", [
    (clip_mod.CLIPEncoder, "__call__", _wrong_images),
    (beam_mod, "beam_search_batched", _altered_tokens),
    (dsv2, "_combine", _without_identity),
], ids=["wrong_images", "token_altered", "identity_experts_left_out"])
def test_broken_path_is_not_correct(owner, attr, make):
    with mock.patch.object(owner, attr, make(getattr(owner, attr))):
        result = _run()
    assert result["correct"] is False, result["checks"]


def test_new_metrics_match_their_entries():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for name in NEW:
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        mod = harness.metric_module(name)
        assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
        assert entry["workloads"] == [CELL]


def test_the_cell_is_off_the_expert_roofline():
    """``moe_experts_roofline`` counts a call's rows from its shape: 7,680 a
    LongCat layer, ~80 computed by 8 of 512 experts (PERF.md §7)."""
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == "moe_experts_roofline")
    assert CELL not in entry["workloads"]


def test_zero_share_reads_the_calls_routing():
    """The tiny model's prefill through the metric's entry: the identity
    pairs are the rows past the FFN experts' last offset."""
    mod = harness.metric_module("moe.zero_share")
    lm = caption_longcat.language_model(_files().cfg, 7, torch.device("cpu"), torch.float32)
    calls, seen = [], []
    orig = dsv2._experts

    def wrapped(moe, rows, offsets):
        calls.append(mod.facts(moe, rows, offsets))
        return orig(moe, rows, offsets)

    def route(moe, h, cfg):
        w, idx = route_orig(moe, h, cfg)
        seen.append(idx)
        return w, idx

    route_orig = dsv2._route
    x = torch.randn(2, 5, 128, generator=torch.Generator().manual_seed(3))
    with mock.patch.object(dsv2, "_experts", wrapped), mock.patch.object(dsv2, "_route", route):
        lc.longcat_apply(lm, inputs_embeds=x)
    assert len(calls) == 2 and all(m == 10 * 3 for m, _ in calls)
    zero = sum(int((idx >= 8).sum()) for idx in seen)
    ctx = SimpleNamespace(work={"kind": "caption"}, calls={"moe.zero_share": calls})
    assert mod.read(ctx) == pytest.approx(100 * zero / 60)
    assert mod.read(SimpleNamespace(work={"kind": "train"}, calls={})) is None


def test_flops_count_the_published_layers():
    """28 double layers' projections, the router over 768, attention over
    its keys and the untied head at the cell's configuration."""
    from portbench import flops_longcat

    cfg = harness.load_json(harness.ROOT / "portbench/configs/vitl14-longcat-flash.json")
    per_row = flops_longcat.positions(cfg, 1, 0, 0)
    mla = (2 * 6144 * 1536 + 2 * 1536 * 64 * 192 + 2 * 6144 * 576 + 2 * 512 * 64 * 256
           + 2 * 64 * 128 * 6144)
    assert per_row == 28 * (2 * mla + 2 * 6 * 6144 * 12288 + 2 * 6144 * 768)
    assert flops_longcat.positions(cfg, 0, 1, 0) == 28 * 2 * 2 * 64 * (192 + 128)
    assert flops_longcat.positions(cfg, 0, 0, 1) == 2 * 6144 * 131072


def test_full_width_search_calls_the_experts_once_a_double_layer():
    """LongCat-Flash-Chat at its published widths (8 of 512 FFN experts
    held, seeded bf16 on the card): the prefill and each of the 7 decode
    steps call the grouped experts once a double layer, 28 × (1 + 7)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the model at its widths takes 56 GB")
    from clipcap_tpu_torch.inference.beam import BeamParams, beam_search_batched
    from clipcap_tpu_torch.ops import moe

    cfg = harness.load_json(harness.ROOT / "portbench/configs/vitl14-longcat-flash.json")
    dev = torch.device("cuda")
    lm = caption_longcat.language_model(cfg, 11, dev, torch.bfloat16)
    prefix = torch.randn(2, 10, 6144, generator=torch.Generator().manual_seed(2)).to(dev)
    before = moe.grouped_expert_mlp.calls
    res = beam_search_batched(lm, prefix, BeamParams(beam_size=5, max_new_tokens=8,
                                                     stop_token=-1), dtype=torch.bfloat16)
    assert moe.grouped_expert_mlp.calls - before == 28 * (1 + 7)
    assert bool(torch.isfinite(res.scores).all())
