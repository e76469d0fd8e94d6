"""The routed experts' share of the device's busy time in a caption unit,
in %: the device operations launched inside the program's ``moe.experts``
span (every ``grouped_expert_mlp`` call of the DeepSeek-V2 model: the
prefill's and each decode step's) ÷ the device busy time of the profiled
units."""
from portbench.program_spans import caption_spans

LAYER = "routed experts"
MOVES = "captions_per_s"


def read(ctx):
    spans = caption_spans(ctx, "moe.experts")
    if not spans or not spans[0].count or ctx.busy_s <= 0:
        return None
    return 100.0 * spans[0].device_s / ctx.busy_s
