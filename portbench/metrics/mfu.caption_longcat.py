"""The LongCat-Flash captioning batch's share of the bf16 peak: model
FLOPs of the batch (tower, mapper, prefill, every decode row-step through
the 28 double layers: 56 latent attentions with the query LoRA, 56 dense
SwiGLUs, the router over 768 outputs, attention over each row's valid
context, the head over the whole vocabulary, and 6·D·F for each
token-expert pair the held experts got: ``flops_longcat.caption_batch``)
÷ (the unprofiled batch time × 989 TFLOP/s).

The pairs are counted from each ``grouped_expert_mlp`` call of the traced
unit (the attribute ``models/deepseek_v2.py`` resolves, which the
LongCat-Flash model calls): its last device offset, the rows of the held
experts, copied at the call and read after the trace.  A call's row count
is fixed at tokens × top-k whatever lands here, so the shape would count
12 pairs a row."""
from portbench import flops_longcat
from portbench.readers import mfu_pct

LAYER = "whole step"
MOVES = "captions_per_s"
ENTRY = "clipcap_tpu_torch.models.deepseek_v2:grouped_expert_mlp"


def facts(x, w13, w2, offsets, **_):
    return offsets[-1:].clone()


def read(ctx):
    w = ctx.work
    calls = ctx.calls.get("mfu.caption_longcat") or []
    if w["kind"] != "caption" or "zero_expert_num" not in ctx.cfg or not calls:
        return None
    pairs = sum(int(c) for c in calls) / w["units"]
    steps = w["decode_steps"] / w["units"]
    return mfu_pct(ctx, "caption", flops_longcat.caption_batch(ctx.cfg, w["batch"],
                                                              w["beam_size"], round(steps), pairs))
