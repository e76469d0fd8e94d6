"""The Mamba decode step's share of the device's busy time in a caption
unit, in %: the device operations launched inside the program's
``mamba.decode`` span (each eager ``mamba_decode`` call of a Granite-4.0-H
beam decode step: the parent's state and window read, the recurrence, the
row's state and window written) ÷ the device busy time of the profiled
units."""
from portbench.program_spans import caption_spans

LAYER = "Mamba recurrence"
MOVES = "captions_per_s"


def read(ctx):
    spans = caption_spans(ctx, "mamba.decode")
    if not spans or not spans[0].count or ctx.busy_s <= 0:
        return None
    return 100.0 * spans[0].device_s / ctx.busy_s
