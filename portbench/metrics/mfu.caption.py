"""The whole captioning batch's share of the bf16 peak: model FLOPs of the
batch (tower, mapper, prefill, every decode row-step through the blocks and
the LM head, attention over each row's valid context: ``flops.caption_batch``)
÷ (the unprofiled batch time × 989 TFLOP/s)."""
from portbench import flops
from portbench.readers import mfu_pct

LAYER = "whole step"
MOVES = "captions_per_s"


def read(ctx):
    w = ctx.work
    if w["kind"] != "caption":
        return None
    steps = w["decode_steps"] / w["units"]
    return mfu_pct(ctx, "caption", flops.caption_batch(ctx.cfg, w["batch"], w["beam_size"],
                                                       round(steps)))
