"""Device time of the prefill, in ms a unit: the device operations launched
inside the program's ``beam.prefill`` span (the beam cache, the prefix
through GPT-2, the first LM-head product and top-k) ÷ the profiled units."""
from portbench.program_spans import caption_spans

LAYER = "prefill"
MOVES = "captions_per_s"


def read(ctx):
    spans = caption_spans(ctx, "beam.prefill")
    if not spans or not spans[0].count:
        return None
    return 1e3 * spans[0].device_s / ctx.work["units"]
