"""Host time of a decode step under the profiler, in ms: the host duration
of the program's ``beam.step`` and ``beam.stop_check`` spans ÷ the
``beam.step`` spans.  The profiler's own cost per op is inside it, so it
reads above the unprofiled step."""
from portbench.program_spans import caption_spans

LAYER = "decode loop"
MOVES = "captions_per_s"


def read(ctx):
    spans = caption_spans(ctx, "beam.step", "beam.stop_check")
    if not spans or not spans[0].count:
        return None
    step, check = spans
    return (step.host_us + check.host_us) / 1e3 / step.count
