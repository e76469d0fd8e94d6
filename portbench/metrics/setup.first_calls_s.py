"""Seconds of the program's outermost first calls: the host time of each
span's first occurrence in the process that began inside no other one-time
section (``utils/profiling.py::ONCE``, ``first.<span>`` with no parent),
summed.  Set-up runs first in the process, so these are the warm-up's first
encoder, mapper, prefill, stop check and decode step, or its first train
step's phases, each with the one-time work inside it (allocator growth,
module loading, library handles, GEMM plan choice, graph captures).

Prints the record to stderr as one ``once:`` line: the entries of largest
self time, each as ``name xcount seconds (self seconds)``.  A program
without the record reads nothing."""
import sys

LAYER = "set-up"
MOVES = "setup_s"
SHOWN = 12


def read(ctx):
    from clipcap_tpu_torch.utils import profiling

    once = getattr(profiling, "ONCE", None)
    if once is None:
        return None
    rows = sorted(once.totals, key=once.self_seconds, reverse=True)[:SHOWN]
    print("once: " + "; ".join(f"{n} x{once.counts[n]} {once.totals[n]:.3f} s "
                               f"(self {once.self_seconds(n):.3f})" for n in rows),
          file=sys.stderr)
    firsts = [s for n, s in once.totals.items()
              if n.startswith("first.") and once.parents.get(n) is None]
    return sum(firsts) if firsts else None
