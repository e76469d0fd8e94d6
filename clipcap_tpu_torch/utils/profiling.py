"""Tracing and timing hooks: the API of ``clipcap_tpu/utils/profiling.py``
on ``torch.profiler``.

* ``trace(logdir)`` — a ``torch.profiler`` trace (CPU, and CUDA where
  present) written into ``logdir`` as a Chrome/TensorBoard trace; a no-op
  when ``logdir`` is falsy.
* ``annotate(name)`` — a named region on the profiler's timeline
  (``record_function``), and an NVTX range when CUDA is present.
* ``timed(fn, *args)`` / ``Timer`` — wall-clock timing; ``timed``
  synchronises the card before the clock stops when the result holds a
  CUDA tensor (launches return before the device has run them).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace into ``logdir``; no-op when logdir is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(logdir)):
        yield


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named trace region (profiler timeline, and NVTX on CUDA)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _sync(result: Any) -> None:
    """Wait for the card when ``result`` holds a CUDA tensor."""
    stack = [result]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
                return
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)


def timed(fn: Callable, *args, rounds: int = 1, **kwargs):
    """Run ``fn`` ``rounds`` times after one warm-up call; return
    (last_result, seconds_per_round).  Synchronises after the warm-up and
    after the timed loop — the device runs launches in order, so the last
    wait bounds every round."""
    result = fn(*args, **kwargs)
    _sync(result)
    t0 = time.perf_counter()
    for _ in range(rounds):
        result = fn(*args, **kwargs)
    _sync(result)
    return result, (time.perf_counter() - t0) / max(1, rounds)


class Timer:
    """Accumulating section timer for loop telemetry (host-side only).

    >>> t = Timer()
    >>> with t.section("data"): batch = next(loader)
    >>> with t.section("step"): loss = step(batch)
    >>> t.summary()  # {'data': ..., 'step': ...} seconds
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, float]:
        return dict(self.totals)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
