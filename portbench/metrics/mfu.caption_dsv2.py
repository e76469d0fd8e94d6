"""The DeepSeek-V2 captioning batch's share of the bf16 peak: model FLOPs
of the batch (tower, mapper, prefill, every decode row-step through the
27 layers with each row's active parameters and the head over the whole
vocabulary, attention over each row's valid context:
``flops_dsv2.caption_batch``) ÷ (the unprofiled batch time × 989 TFLOP/s)."""
from portbench import flops_dsv2
from portbench.readers import mfu_pct

LAYER = "whole step"
MOVES = "captions_per_s"


def read(ctx):
    w = ctx.work
    if w["kind"] != "caption" or "hidden_size" not in ctx.cfg:
        return None
    steps = w["decode_steps"] / w["units"]
    return mfu_pct(ctx, "caption", flops_dsv2.caption_batch(ctx.cfg, w["batch"],
                                                            w["beam_size"], round(steps)))
