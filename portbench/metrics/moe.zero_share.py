"""The zero-computation experts' share of the routed picks in a caption
unit, in %: the token-expert pairs that chose an identity expert ÷ all
pairs, over every expert-layer call of the traced unit (the prefill's and
each decode step's).

Read at each call of ``_experts`` (the attribute ``models/deepseek_v2.py``
resolves, which the LongCat-Flash model calls with the whole routing):
its rows, one a pair (T·k, from the shape), and its last device offset,
where the identity experts' pairs begin (they sort past every FFN
expert), copied at the call and read after the trace.  A router without
identity experts reads 0.

A guard on the routing, not a target: the share is the model's
mathematics (about 256/768 of the picks with seeded weights), not the
port's speed.  ``BENCHMARK.json`` has to give it a direction; a move
either way means the routing changed, which is a fault and not a gain."""
LAYER = "routed experts"
MOVES = "captions_per_s"
ENTRY = "clipcap_tpu_torch.models.deepseek_v2:_experts"


def facts(moe, rows, offsets, **_):
    return rows.shape[0], offsets[-1:].clone()


def read(ctx):
    calls = ctx.calls.get("moe.zero_share") or []
    if ctx.work["kind"] != "caption" or not calls:
        return None
    pairs = sum(m for m, _ in calls)
    zero = sum(m - int(ffn) for m, ffn in calls)
    return 100.0 * zero / pairs if pairs else None
