"""The training step's share of the bf16 peak: the step's model FLOPs (the
forward, the backward to activations through the frozen LM, the weight
gradients of what is trained: ``flops.train_step``) ÷ (the unprofiled step
time × 989 TFLOP/s)."""
from portbench import flops
from portbench.readers import mfu_pct

LAYER = "whole step"
MOVES = "train_samples_per_s"


def read(ctx):
    w = ctx.work
    if w["kind"] != "train":
        return None
    return mfu_pct(ctx, "train", flops.train_step(ctx.cfg, w["batch"], w["tokens"],
                                                  w["train_language_model"]))
