"""Device time of a decode step, in ms: the device operations launched
inside the program's ``beam.step`` and ``beam.stop_check`` spans ÷ the
``beam.step`` spans (the decode steps that ran a forward)."""
from portbench.program_spans import caption_spans

LAYER = "decode loop"
MOVES = "captions_per_s"


def read(ctx):
    spans = caption_spans(ctx, "beam.step", "beam.stop_check")
    if not spans or not spans[0].count:
        return None
    step, check = spans
    return 1e3 * (step.device_s + check.device_s) / step.count
