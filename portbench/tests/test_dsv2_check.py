"""The check of the DeepSeek-V2 caption kind (``kinds/caption_dsv2.py``) on
a tiny cell on the CPU, as ``test_checks.py`` holds the GPT-2 kinds: a
sound run comes out correct, the control (the reference in float8 in the
program's place) reads above a limit, and a batch answered for the wrong
images or a token altered comes out not correct.  The tiny cell takes
``conftest.TINY_LIMITS``' caption limits and ``tiny_dsv2.json``: every
mechanism of the model at tiny widths."""
import json
from types import SimpleNamespace
from unittest import mock

import pytest
import torch

from conftest import HERE, TINY_LIMITS, TINY_TRAFFIC

from clipcap_tpu_torch.encoders import clip as clip_mod
from clipcap_tpu_torch.inference import beam as beam_mod

from portbench import harness
from portbench.kinds import caption_dsv2
from portbench.traffic import generate

CELL = "caption.vitl14-dsv2lite.b128"


def _files() -> SimpleNamespace:
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    real = harness.cell_files(bench, CELL)
    _, cut = TINY_TRAFFIC["caption"]
    spec = dict(real.spec, limits=TINY_LIMITS["caption"], check_images=4)
    return SimpleNamespace(entry={"name": "tiny.caption_dsv2", "chips": 1},
                           cfg=json.loads((HERE / "tiny_dsv2.json").read_text()),
                           traffic=dict(generate.load("caption_dsv2.b128"), **cut), spec=spec,
                           kind=caption_dsv2)


def _run(seed: int = 123456789012) -> dict:
    args = SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    return harness.run_cell(_files(), {"end_to_end": [], "per_layer": []}, args,
                            torch.device("cpu"), 0.0)


def test_cell_names_the_kind():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    assert harness.cell_files(bench, CELL).kind is caption_dsv2


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


@pytest.mark.parametrize("owner,attr,make", [
    (clip_mod.CLIPEncoder, "__call__", _wrong_images),
    (beam_mod, "beam_search_batched", _altered_tokens),
], ids=["wrong_images", "token_altered"])
def test_broken_path_is_not_correct(owner, attr, make):
    with mock.patch.object(owner, attr, make(getattr(owner, attr))):
        result = _run()
    assert result["correct"] is False, result["checks"]


# (span, metric): the cell's span-share metrics, on a hand-built trace of a
# prefill and one decode step with device operations inside and outside.
SHARES = [("dsv2.lm_head", "lm_head.caption_dsv2"), ("moe.experts", "moe.experts_share")]


@pytest.mark.parametrize("span,name", SHARES, ids=[m for _, m in SHARES])
def test_span_shares_read_their_span(span, name):
    from test_program_spans import FakeTrace

    host = [(10, 50, "beam.prefill"), (20, 30, span), (100, 200, "beam.step"), (150, 160, span)]
    device = [(1000, 5000, "prefill", 12), (5000, 5200, "inside", 25),
              (7000, 8000, "step", 120), (8000, 8500, "inside", 155)]

    def ctx(kind="caption", host=host):
        tr = FakeTrace(host, device)
        return SimpleNamespace(work={"kind": kind, "units": 1}, range_s=tr.range_s, busy_s=0.01)

    mod = harness.metric_module(name)
    assert mod.read(ctx()) == pytest.approx(100 * 700e-6 / 0.01)
    assert mod.read(ctx(host=[h for h in host if h[2] != span])) is None
    assert mod.read(ctx(kind="train")) is None
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    assert (mod.LAYER, mod.MOVES) == (entry["layer"], entry["moves"])
    assert entry["workloads"] == [CELL]
