"""The metrics that read the program's spans and counters
(``program_spans.py`` and five files under ``metrics/``), on a hand-built
trace of two decode steps with device operations launched inside and
outside the spans.

Run from the root of the checkout: ``python -m pytest portbench/tests -q``.
"""
from types import SimpleNamespace

import pytest

from clipcap_tpu_torch.inference import beam as beam_mod

from portbench import harness, program_spans

CELLS = ["caption.vitb32-gpt2.b128", "caption.vitl14-gpt2xl.b96"]
NEW = ["decode.device_ms_per_step", "decode.host_ms_per_step", "decode.syncs_per_step",
       "prefill.device_ms", "lm_head.caption"]


class FakeTrace:
    """``trace.Trace``'s fields, in µs: ``host`` (start, end, name) of the
    main thread, ``device`` (start, end, name, launch time)."""

    def __init__(self, host, device):
        self.host, self.device = sorted(host, key=lambda t: (t[0], -t[1])), device

    def range_s(self, label):
        return None


HOST = [(10, 50, "beam.prefill"), (20, 30, "gpt2.lm_head"),
        (90, 95, "beam.stop_check"), (100, 200, "beam.step"), (150, 160, "gpt2.lm_head"),
        (170, 190, "beam.rank"),
        (290, 295, "beam.stop_check"), (300, 400, "beam.step"), (350, 360, "gpt2.lm_head"),
        (500, 504, "beam.stop_check"),
        (12, 13, "cudaLaunchKernel"), (120, 121, "cudaLaunchKernel")]
# (start, end, name, launch): each device operation and where it was launched.
DEVICE = [(1000, 5000, "prefill gemm", 12), (5000, 5200, "head", 25),
          (6000, 6100, "all", 92),
          (7000, 8000, "block", 120), (8000, 8500, "head", 155), (8500, 8600, "rank", 180),
          (9000, 11000, "block", 320), (11000, 11300, "head", 355),
          (12000, 19000, "outside", 250), (19000, 19400, "all", 502),
          (20000, 21000, "no launch", None)]


def _ctx(kind="caption", host=HOST, device=DEVICE, busy_s=0.02, units=2):
    tr = FakeTrace(host, device)
    return SimpleNamespace(work={"kind": kind, "units": units}, range_s=tr.range_s,
                           busy_s=busy_s)


def test_span_counts_host_and_launched_device_time():
    tr = program_spans.trace_of(_ctx())
    assert program_spans.span(tr, "beam.step") == (2, 200, (1000 + 500 + 100 + 2000 + 300) / 1e6)
    assert program_spans.span(tr, "beam.stop_check") == (3, 14, (100 + 400) / 1e6)
    assert program_spans.span(tr, "gpt2.lm_head") == (3, 30, (200 + 500 + 300) / 1e6)
    assert program_spans.span(tr, "absent") == (0, 0, 0.0)


@pytest.fixture
def counters(monkeypatch):
    f = beam_mod.beam_search_batched
    monkeypatch.setattr(f, "decode_steps", 132, raising=False)
    monkeypatch.setattr(f, "host_syncs", 133, raising=False)
    return f


def test_metrics_read_the_spans(counters):
    ctx = _ctx()
    read = {n: harness.metric_module(n).read(ctx) for n in NEW}
    assert read["decode.device_ms_per_step"] == pytest.approx((3.9 + 0.5) / 2)
    assert read["decode.host_ms_per_step"] == pytest.approx((200 + 14) / 1e3 / 2)
    assert read["decode.syncs_per_step"] == pytest.approx(133 / 132)
    assert read["prefill.device_ms"] == pytest.approx((4.0 + 0.2) / 2)
    assert read["lm_head.caption"] == pytest.approx(100 * 1.0e-3 / 0.02)


@pytest.mark.parametrize("name", NEW)
def test_metrics_read_nothing_without_the_program_spans(name, monkeypatch):
    """A program without the spans and counters (as before they were
    added), or a cell of another kind: no reading, no error."""
    f = beam_mod.beam_search_batched
    for attr in ("decode_steps", "host_syncs"):
        if hasattr(f, attr):
            monkeypatch.delattr(f, attr)
    mod = harness.metric_module(name)
    bare = [h for h in HOST if h[2] == "cudaLaunchKernel"]
    assert mod.read(_ctx(host=bare)) is None
    assert mod.read(_ctx(kind="train")) is None


@pytest.mark.parametrize("name", NEW)
def test_metrics_match_their_benchmark_entries(name):
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    mod = harness.metric_module(name)
    assert mod.LAYER == entry["layer"] and mod.MOVES == entry["moves"] == "captions_per_s"
    assert entry["workloads"] == CELLS
