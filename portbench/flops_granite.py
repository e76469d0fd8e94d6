"""Model FLOPs of a Granite-4.0-H captioning batch, from the configuration.

Counted as ``flops.py`` counts (a product of ``[m, k]`` and ``[k, n]`` is
``2·m·k·n``; norms, activations, the softmax and lookups are not counted),
over the model's own forward as published: per position and layer, a
Mamba layer's ``in_proj`` and ``out_proj``, its convolution (2·4 per xBC
channel) and its recurrence (5·P·N per head: the decay, the rank-one
update, h·C); an attention layer's projections (q, k, v, o); the router
over all ``num_local_experts_published`` experts and the shared MLP.  The
routed experts count 6·D·F per token-expert pair held here (the pairs a
traced unit gave the held experts, from the program's device offsets), not
top-k a row.  Attention over ``c`` keys counts ``4·H·Dh·c`` per query and
attention layer; the tied head 2·D·V per logit row.
"""
from __future__ import annotations

from portbench import flops


def positions(c: dict, n: float, attended: float, logit_rows: float) -> float:
    """``n`` query positions attending to ``attended`` keys in all, with
    ``logit_rows`` rows through the head; the routed experts apart."""
    D, H, Hkv = c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"]
    Dh = D // H
    Hm, Pm, Nm = c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"]
    inner = c["mamba_expand"] * D
    C = inner + 2 * c["mamba_n_groups"] * Nm
    mamba = (2 * D * (inner + C + Hm) + 2 * inner * D + 2 * c["mamba_d_conv"] * C
             + 5 * Hm * Pm * Nm)
    attention = 2 * D * (H + 2 * Hkv) * Dh + 2 * H * Dh * D
    moe = 2 * D * c["num_local_experts_published"] + 6 * D * c["shared_intermediate_size"]
    types = c["layer_types"]
    per_position = sum(mamba if t == "mamba" else attention for t in types) + len(types) * moe
    per_key = sum(t != "mamba" for t in types) * 4 * H * Dh
    return per_position * n + per_key * attended + 2 * D * c["vocab_size"] * logit_rows


def caption_batch(cfg: dict, batch: int, beam: int, decode_steps: int,
                  expert_pairs: float) -> float:
    """One beam-search batch, as ``flops.caption_batch``: the tower and
    mapper per image, the causal prefill of the P prefix positions with the
    last through the head, then ``decode_steps`` steps of ``batch·beam``
    rows, step s attending to its P + s positions; plus ``expert_pairs``
    token-expert pairs through the held experts."""
    P = cfg["mapper"]["prefix_length"]
    total = batch * (flops.vit_image(cfg["encoder"]) + flops.mapper_sample(cfg["mapper"]))
    total += positions(cfg, batch * P, batch * P * (P + 1) / 2, batch)
    rows = batch * beam
    for s in range(1, decode_steps + 1):
        total += positions(cfg, rows, rows * (P + s), rows)
    return total + expert_pairs * 6 * cfg["hidden_size"] * cfg["intermediate_size"]
