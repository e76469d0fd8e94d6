"""``metrics/decode.graph_share.py``: the share of decode steps that
replayed CUDA graphs, from the program's counters.

Run from the root of the checkout: ``python -m pytest portbench/tests -q``.
"""
from types import SimpleNamespace

import pytest

from clipcap_tpu_torch.inference import beam as beam_mod

from portbench import harness

NAME = "decode.graph_share"
CELLS = ["caption.vitb32-gpt2.b128", "caption.vitl14-gpt2xl.b96"]


def _ctx(kind="caption"):
    return SimpleNamespace(work={"kind": kind, "units": 1})


def test_share_of_graphed_steps(monkeypatch):
    f = beam_mod.beam_search_batched
    monkeypatch.setattr(f, "decode_steps", 132, raising=False)
    monkeypatch.setattr(f, "graph_steps", 131, raising=False)
    assert harness.metric_module(NAME).read(_ctx()) == pytest.approx(100 * 131 / 132)


@pytest.mark.parametrize("missing", ["graph_steps", "decode_steps"])
def test_reads_nothing_without_the_counters(missing, monkeypatch):
    """A program without the graph counter (as before it was added), no
    decode step yet, or a cell of another kind: no reading, no error."""
    f = beam_mod.beam_search_batched
    monkeypatch.setattr(f, "decode_steps", 10, raising=False)
    monkeypatch.setattr(f, "graph_steps", 9, raising=False)
    monkeypatch.delattr(f, missing)
    mod = harness.metric_module(NAME)
    assert mod.read(_ctx()) is None
    assert mod.read(_ctx(kind="train")) is None


def test_matches_its_benchmark_entry():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == NAME)
    mod = harness.metric_module(NAME)
    assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"] == "captions_per_s"
    assert entry["workloads"] == CELLS
    assert (entry["unit"], entry["better"], entry["source"]) == ("%", "higher",
                                                               "program_counter")
