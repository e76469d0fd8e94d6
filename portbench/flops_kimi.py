"""Model FLOPs of a Kimi-Linear captioning batch, from the configuration.

Counted as ``flops.py`` counts (a product of ``[m, k]`` and ``[k, n]`` is
``2·m·k·n``; norms, activations, the softmax and lookups are not counted),
over the model's own forward as published: per position and layer, a KDA
layer's projections (q, k, v, the decay's and the output gate's low-rank
pairs, β, ``o_proj``), its convolutions (2·4 per channel of q, k and v)
and its recurrence (7·d² per head: the decay, Sᵀk, the rank-one update,
Sᵀq); an MLA layer's projections and the decompression of the position's
keys and values (``kv_b_proj``); the dense SwiGLU, or the router over all
``num_experts_published`` experts and the shared expert.  The routed
experts count 6·D·F per token-expert pair held here (the pairs a traced
unit gave the held experts, from the program's device offsets), not top-k
a row.  Attention over ``c`` keys counts ``2·H·(nope + rope + v)·c`` per
query and MLA layer; the untied head 2·D·V per logit row.  The absorbed
decode the program runs does other products; these are the model's.
"""
from __future__ import annotations

from portbench import flops


def positions(c: dict, n: float, attended: float, logit_rows: float) -> float:
    """``n`` query positions attending to ``attended`` keys in all, with
    ``logit_rows`` rows through the head; the routed experts apart."""
    D, H = c["hidden_size"], c["num_attention_heads"]
    nope, r, vd, C = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                      c["kv_lora_rank"])
    la = c["linear_attn_config"]
    Hk, d = la["num_heads"], la["head_dim"]
    HD = Hk * d
    kda = (2 * D * 3 * HD + 2 * (2 * (D * d + d * HD)) + 2 * D * Hk + 2 * HD * D
           + 3 * HD * 2 * la["short_conv_kernel_size"] + 7 * Hk * d * d)
    mla = 2 * D * H * (nope + r) + 2 * D * (C + r) + 2 * C * H * (nope + vd) + 2 * H * vd * D
    Fm = c["moe_intermediate_size"]
    moe = 2 * D * c["num_experts_published"] + 6 * D * Fm * c["num_shared_experts"]
    dense = 6 * D * c["intermediate_size"]
    per_position, mla_layers = 0.0, 0
    for i in range(c["num_hidden_layers"]):
        is_kda = i + 1 in la["kda_layers"]
        mla_layers += not is_kda
        is_moe = i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0
        per_position += (kda if is_kda else mla) + (moe if is_moe else dense)
    per_key = mla_layers * 2 * H * (nope + r + vd)
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
    return total + expert_pairs * 6 * cfg["hidden_size"] * cfg["moe_intermediate_size"]
