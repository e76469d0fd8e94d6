"""The Granite-4.0-H captioning batch's share of the bf16 peak: model FLOPs
of the batch (tower, mapper, prefill, every decode row-step through the
40 layers, the router over all 72 experts, the head over the whole
vocabulary, attention over each row's valid context, and 6·D·F for each
token-expert pair the held experts got: ``flops_granite.caption_batch``)
÷ (the unprofiled batch time × 989 TFLOP/s).

The pairs are counted from each ``grouped_expert_mlp`` call of the traced
unit (the attribute ``models/deepseek_v2.py`` resolves, which the
Granite-4.0-H model calls): its last device offset, the rows of the held
experts, copied at the call and read after the trace.  A call's row count
is fixed at tokens × top-k whatever lands here, so the shape would count
10 pairs a row."""
from portbench import flops_granite
from portbench.readers import mfu_pct

LAYER = "whole step"
MOVES = "captions_per_s"
ENTRY = "clipcap_tpu_torch.models.deepseek_v2:grouped_expert_mlp"


def facts(x, w13, w2, offsets, **_):
    return offsets[-1:].clone()


def read(ctx):
    w = ctx.work
    calls = ctx.calls.get("mfu.caption_granite") or []
    if w["kind"] != "caption" or "num_local_experts_published" not in ctx.cfg or not calls:
        return None
    pairs = sum(int(c) for c in calls) / w["units"]
    steps = w["decode_steps"] / w["units"]
    return mfu_pct(ctx, "caption", flops_granite.caption_batch(ctx.cfg, w["batch"],
                                                              w["beam_size"], round(steps), pairs))
