"""The DeepSeek-V2 LM head's share of the device's busy time in a caption
unit, in %: the device operations launched inside the program's
``dsv2.lm_head`` span (every product with the untied head over the whole
vocabulary: the prefill's and each decode step's) ÷ the device busy time
of the profiled units."""
from portbench.program_spans import caption_spans

LAYER = "LM head"
MOVES = "captions_per_s"


def read(ctx):
    spans = caption_spans(ctx, "dsv2.lm_head")
    if not spans or not spans[0].count or ctx.busy_s <= 0:
        return None
    return 100.0 * spans[0].device_s / ctx.busy_s
