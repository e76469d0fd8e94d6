"""Loop telemetry: the accumulating section timer of
``clipcap_tpu/utils/profiling.py`` (``Timer``), host clock only.  Device
tracing in the port is ``torch.profiler`` (``train --profile-dir``)."""
from __future__ import annotations

import contextlib
import time
from typing import Iterator


class Timer:
    """Accumulating section timer for loop telemetry (host-side only).

    >>> t = Timer()
    >>> with t.section("data"): batch = next(loader)
    >>> with t.section("step"): loss = step(batch)
    >>> t.summary()  # {'data': ..., 'step': ...} seconds
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt

    def summary(self) -> dict[str, float]:
        return dict(self.totals)
