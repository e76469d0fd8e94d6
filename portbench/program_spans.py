"""The program's own spans in a traced run.

``clipcap_tpu_torch`` opens a ``record_function`` range at each layer
boundary (``utils/profiling.py::annotate``: ``beam.prefill``, ``beam.step``,
``beam.stop_check``, ``gpt2.lm_head``, ...) whenever a profiler records.
They sit in the same ``torch.profiler`` trace as the device operations, on
the same clock.  ``ctx.range_s`` is the bound method of the traced run's
``Trace`` (``trace.py``), whose ``host`` holds the main thread's host events
(the spans among them, in µs) and ``device`` each device operation with its
launch time.

``span(tr, name)`` gives the count of the span's intervals, their host time
and the device time of the operations launched inside them (each matched
to its launch by correlation id, as ``Trace.range_s`` does for the
benchmark's own ranges).  A program that opens no such span reads count 0,
and the metrics then read nothing.
"""
from __future__ import annotations

import bisect
from typing import NamedTuple


class Span(NamedTuple):
    count: int        # intervals
    host_us: float    # their summed host time
    device_s: float   # device time of the operations launched inside them


def trace_of(ctx):
    """The traced run's ``Trace``, or None."""
    return getattr(ctx.range_s, "__self__", None)


def span(tr, name: str) -> Span:
    intervals = sorted((s, e) for s, e, n in tr.host if n == name)
    starts = [s for s, _ in intervals]
    device_us = 0.0
    for s, e, _, t in tr.device:
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= intervals[i][1]:
                device_us += e - s
    return Span(len(intervals), sum(e - s for s, e in intervals), device_us / 1e6)


def caption_spans(ctx, *names: str):
    """``span`` of each name in a caption cell's trace; None for another
    kind or a trace without one."""
    tr = trace_of(ctx)
    if ctx.work["kind"] != "caption" or tr is None:
        return None
    return [span(tr, n) for n in names]
