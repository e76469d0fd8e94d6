"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It needs a CUDA card (it exits non-zero and
prints no result without one), builds the port's kernels into the
checkout's ``build/`` on a first run, and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` (each compared number beside
its limit).  See ``harness.py``.
"""
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """Wall time at which this process started (``/proc``), else now."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


STARTED = _process_start()
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

if __name__ == "__main__":
    import json

    from portbench import env

    env.setup()
    from portbench.harness import main

    print(json.dumps(main(started=STARTED)), flush=True)
