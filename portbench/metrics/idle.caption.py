"""Idle share of the device in a caption unit: 1 − device busy time (the union
of the profiled unit's device operations) ÷ the unit's time in the
unprofiled window."""
from portbench.readers import idle_pct

LAYER = "device"
MOVES = "captions_per_s"


def read(ctx):
    return idle_pct(ctx, "caption")
