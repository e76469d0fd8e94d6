"""Tracing and timing hooks: the API of ``clipcap_tpu/utils/profiling.py``
on ``torch.profiler``.

* ``trace(logdir)`` — a ``torch.profiler`` trace (CPU, and CUDA where
  present) of the block, written as the Chrome trace ``<logdir>/trace.json``;
  a no-op when ``logdir`` is falsy.
* ``annotate(name)`` — the program's span: a ``record_function`` range on
  the timeline of whatever profiler is recording (``torch.profiler``,
  ``trace`` above, or ``torch.autograd.profiler.emit_nvtx``, under which it
  is also the NVTX range), and nothing at all while none is.
* ``timed(fn, *args)`` / ``Timer`` — wall-clock timing; ``timed``
  synchronises the card before the clock stops when the result holds a
  CUDA tensor (launches return before the device has run them).
  ``Timer.section`` opens a span of the section's name too, and records
  the section open when it began (its parent), so a section's self time is
  its seconds less its children's.
* ``ONCE`` — the process's record of one-time work, a ``Timer`` that is
  always on and never reset by the program (``reset_once`` is for tests):
  ``first.<span>``, the host seconds of each span's first occurrence in the
  process (``annotate`` times it whether or not a profiler records; the
  outermost ones hold the first unit of each layer with every one-time cost
  inside it: allocator growth, module loading, library handles, GEMM plan
  choice); ``kernels.load`` (``ops/_build.py::load_library``: hashing the
  sources, the library's load and bindings) holding ``kernels.build`` (one
  a ``nvcc`` build); ``graphs.capture`` (``models/decoding.py::StepGraphs``:
  one a decode segment captured, its warm-up and first replay included).
  The benchmark's ``setup.*`` metrics read it.

The spans on the main paths (each a layer boundary; nested ones inside):

* ``encoder.h2d`` / ``encoder.tower`` / ``encoder.d2h`` —
  ``encoders/clip.py::CLIPEncoder``: the images' copy to the device, the
  tower, the embeddings' copy back;
* ``mapper`` — ``models/mapper.py::mapper_apply``;
* ``beam.prefill``, then per loop iteration ``beam.stop_check`` (the one
  blocking read of a step) and ``beam.step`` (a step that runs a forward)
  holding ``beam.rank`` — ``inference/beam.py::beam_search_batched``;
* ``gpt2.blocks`` (the layer loop) and ``gpt2.lm_head`` (every product
  with the tied head) — ``models/gpt2.py``; ``dsv2.blocks`` /
  ``dsv2.lm_head``, ``kimi.blocks`` / ``kimi.lm_head``, ``granite.blocks``
  / ``granite.lm_head`` the same in the other families, with ``mla.decode``
  and ``moe.experts`` around their shared latent attention and grouped
  experts, ``kda.decode`` / ``kda.prefill`` around Kimi-Linear's KDA
  steps, ``mamba.decode`` / ``mamba.prefill`` around Granite-4.0-H's Mamba
  steps and ``gqa.decode`` around its decode attention;
* ``train.data_wait`` / ``train.forward`` / ``train.backward`` /
  ``train.optimizer`` — ``train/train.py`` and ``train/step.py``.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the block into ``<logdir>/trace.json``;
    no-op when logdir is falsy."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(logdir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


_OFF = contextlib.nullcontext()
_SEEN: set[str] = set()     # span names entered in this process


def annotate(name: str):
    """The span ``name``: a ``record_function`` range while a profiler
    records, else a shared no-op context (no profiler op dispatched, no
    NVTX range pushed).  The flag is a module global that every profiler
    sets on entry, so it is read through its module on each call.

    A name's first call in the process is also timed into ``ONCE`` as
    ``first.<name>``; every later call costs one set lookup more than the
    range alone."""
    if name not in _SEEN and _claim(name):
        return _first(name)
    # ``_range`` inlined: every span call of the main paths comes here.
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def _range(name: str):
    """``annotate``'s range without the first-call record."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def _claim(name: str) -> bool:
    """Mark ``name`` seen; whether this call was the first to."""
    with ONCE.lock:
        first = name not in _SEEN
        _SEEN.add(name)
    return first


@contextlib.contextmanager
def _first(name: str) -> Iterator[None]:
    with ONCE.timed(f"first.{name}"), _range(name):
        yield


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

    Per section: its seconds (``totals``), its count, the section open
    when it first began (``parents``, None for an outermost one; one stack
    for all threads, so work that a blocked caller waits for on another
    thread, as on autograd's worker, nests under it) and the seconds of the
    sections opened inside it, so ``self_seconds`` is its seconds less its
    children's.
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.parents: dict[str, Optional[str]] = {}
        self.inner: dict[str, float] = {}
        self.lock = threading.Lock()
        self._open: list[str] = []

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        with self.timed(name), _range(name):
            yield

    @contextlib.contextmanager
    def timed(self, name: str) -> Iterator[None]:
        """``section`` without the span."""
        with self.lock:
            parent = self._open[-1] if self._open else None
            self.parents.setdefault(name, parent)
            self._open.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self.lock:
                self._open.pop()              # sections nest: the newest is this one
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1
                if parent is not None:
                    self.inner[parent] = self.inner.get(parent, 0.0) + dt

    def self_seconds(self, name: str) -> float:
        return self.totals[name] - self.inner.get(name, 0.0)

    def summary(self) -> dict[str, float]:
        return dict(self.totals)

    def reset(self) -> None:
        with self.lock:
            for d in (self.totals, self.counts, self.parents, self.inner):
                d.clear()
            self._open.clear()


ONCE = Timer()     # one-time work of the process (module docstring)


def reset_once() -> None:
    """Clear ``ONCE`` and the span names seen, together (for tests)."""
    with ONCE.lock:
        _SEEN.clear()
    ONCE.reset()
