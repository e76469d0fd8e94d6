"""Device operations (kernels, copies, fills) in the profiled captioning
batch ÷ its decode steps: the eager launches a decode step costs the host."""
LAYER = "decode loop"
MOVES = "captions_per_s"


def read(ctx):
    steps = ctx.work.get("decode_steps", 0)
    if ctx.work["kind"] != "caption" or not steps or not ctx.kernels:
        return None
    return ctx.kernels / steps
