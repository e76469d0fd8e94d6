"""The embedding batch's share of the bf16 peak: the tower's model FLOPs
(``flops.vit_image`` per image) ÷ (the unprofiled batch time × 989
TFLOP/s)."""
from portbench import flops
from portbench.readers import mfu_pct

LAYER = "whole step"
MOVES = "embeds_per_s"


def read(ctx):
    return mfu_pct(ctx, "embed", ctx.work["batch"] * flops.vit_image(ctx.cfg["encoder"]))
