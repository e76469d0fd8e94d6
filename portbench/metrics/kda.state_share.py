"""The KDA decode step's share of the device's busy time in a caption unit,
in %: the device operations launched inside the program's ``kda.decode``
span (each eager ``kda_decode`` call of a Kimi-Linear beam decode step:
the parent's state read, the delta rule, the row's state written) ÷ the
device busy time of the profiled units."""
from portbench.program_spans import caption_spans

LAYER = "KDA recurrence"
MOVES = "captions_per_s"


def read(ctx):
    spans = caption_spans(ctx, "kda.decode")
    if not spans or not spans[0].count or ctx.busy_s <= 0:
        return None
    return 100.0 * spans[0].device_s / ctx.busy_s
