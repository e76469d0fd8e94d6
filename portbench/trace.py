"""Reading a ``torch.profiler`` trace of the traced run.

* ``busy_s``: the union of the intervals in which a device operation
  (kernel, copy, fill) ran, the method of ``chip_smoke.py::profile`` (one
  stream, so the union is the sum of the kernel times);
* ``range_s``: the device time of the operations launched inside a
  ``record_function`` range: each operation is matched to its launch (the
  runtime call with its correlation id), and counted where the launch lies
  in one of the range's host intervals;
* ``breakdown``: the device operations that took most time, and the
  longest idle gaps of the device, by the host operation that was running
  on the main thread when the gap began.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

DEVICE = torch.autograd.DeviceType.CUDA
RUNTIME = ("cuda_runtime", "cuda_driver")


def _activity(e):
    return getattr(e, "activity_type", None)


def _is_annotation(e) -> bool:
    return (bool(getattr(e, "is_user_annotation", False)) or e.name.startswith("pb:")
            or _activity(e) == "gpu_user_annotation")


class Trace:
    def __init__(self, prof, wall_s: float):
        self.wall_s = wall_s
        events = list(prof.events())
        device = [e for e in events if e.device_type == DEVICE and not _is_annotation(e)
                  and e.time_range.end > e.time_range.start]
        cpu = [e for e in events if e.device_type != DEVICE]
        # Each device operation's launch: the runtime call that shares its
        # correlation id, on the host clock.
        launches = {e.id: e.time_range.start for e in cpu
                    if _activity(e) in RUNTIME
                    or (_activity(e) is None and e.name.startswith("cu"))}
        self.device = sorted(((e.time_range.start, e.time_range.end, e.name, launches.get(e.id))
                              for e in device), key=lambda d: d[:2])
        self.ranges = collections.defaultdict(list)
        for e in cpu:
            if e.name.startswith("pb:"):
                self.ranges[e.name].append((e.time_range.start, e.time_range.end))
        threads = collections.Counter(e.thread for e in cpu)
        main = threads.most_common(1)[0][0] if threads else None
        self.host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in cpu
                            if e.thread == main), key=lambda t: (t[0], -t[1]))

    @property
    def kernels(self) -> int:
        return len(self.device)

    def busy_s(self) -> float:
        total, end = 0.0, float("-inf")
        for s, e, _, _ in self.device:
            if e > end:
                total += e - max(s, end)
                end = e
        return total / 1e6

    def _launched_in(self, label: str):
        """(name, seconds) of each device operation whose launch lies in
        one of the host intervals of the range ``label``."""
        spans = sorted(self.ranges.get(label, []))
        starts = [a for a, _ in spans]
        for s, e, name, t in self.device:
            if t is not None:
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t <= spans[i][1]:
                    yield name, (e - s) / 1e6

    def range_s(self, label: str):
        """Device seconds of the operations launched inside the host range
        ``label``; None if there are none."""
        total = sum(d for _, d in self._launched_in(label))
        return total if total > 0 else None

    def range_report(self, label: str) -> str:
        """What the range holds, for the log: its device time and the
        operations that took most of it."""
        names = collections.Counter()
        for name, d in self._launched_in(label):
            names[name[:60]] += d
        return (f"{len(self.ranges.get(label, []))} ranges, {self.range_s(label)} s, "
                f"ops {names.most_common(3)}")

    def gaps(self) -> list:
        """(start, length) of each idle stretch between device intervals."""
        out, end = [], None
        for s, e, _, _ in self.device:
            if end is not None and s > end:
                out.append((end, s - end))
            end = e if end is None else max(end, e)
        return out

    def breakdown(self, top: int = 10) -> dict:
        ops = collections.Counter()
        for s, e, name, _ in self.device:
            ops[name] += (e - s) / 1e6
        idle = collections.Counter()
        stack, j = [], 0
        for start, length in self.gaps():
            # A sweep over the host ops in start order: the stack holds the
            # ops open at ``start``, the innermost on top.
            while j < len(self.host) and self.host[j][0] <= start:
                while stack and stack[-1][1] <= self.host[j][0]:
                    stack.pop()
                stack.append(self.host[j])
                j += 1
            while stack and stack[-1][1] <= start:
                stack.pop()
            idle[stack[-1][2] if stack else "(no host op)"] += length / 1e6
        return {"device_ops": [[n[:120], v] for n, v in ops.most_common(top)],
                "idle_gaps": [[n[:120], v] for n, v in idle.most_common(top)]}


@contextlib.contextmanager
def profiled():
    """Profile the block; yields a list that receives the ``Trace``."""
    from torch.profiler import ProfilerActivity, profile

    out = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        yield out
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out.append(Trace(prof, wall))
