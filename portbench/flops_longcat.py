"""Model FLOPs of a LongCat-Flash captioning batch, from the configuration.

Counted as ``flops.py`` counts (a product of ``[m, k]`` and ``[k, n]`` is
``2·m·k·n``; norms, activations, the softmax, RoPE, the identity experts'
weighted add and lookups are not counted), over the model's own forward as
published: per position and double layer, two latent attentions (the query
LoRA ``q_a`` and ``q_b``, the latent projection, the decompression of the
position's keys and values ``kv_b``, ``o_proj``), two dense SwiGLUs of
``ffn_hidden_size`` and the router over all FFN and identity experts.  The
routed experts count 6·D·F per token-expert pair held here (the pairs a
traced unit gave the held experts, from the program's device offsets), not
top-k a row.  Attention over ``c`` keys counts ``2·H·(q_head_dim +
v_head_dim)·c`` per query and latent attention; the untied head 2·D·V per
logit row.  The absorbed decode the program runs does other products;
these are the model's.
"""
from __future__ import annotations

from portbench import flops


def positions(c: dict, n: float, attended: float, logit_rows: float) -> float:
    """``n`` query positions attending to ``attended`` keys in all, with
    ``logit_rows`` rows through the head; the routed experts apart."""
    D, H = c["hidden_size"], c["num_attention_heads"]
    ql, C, r = c["q_lora_rank"], c["kv_lora_rank"], c["qk_rope_head_dim"]
    nope, vd = c["qk_nope_head_dim"], c["v_head_dim"]
    mla = (2 * D * ql + 2 * ql * H * (nope + r) + 2 * D * (C + r) + 2 * C * H * (nope + vd)
           + 2 * H * vd * D)
    router = 2 * D * (c["n_routed_experts_published"] + c["zero_expert_num"])
    per_position = c["num_layers"] * (2 * mla + 2 * 6 * D * c["ffn_hidden_size"] + router)
    per_key = c["num_layers"] * 2 * 2 * H * (nope + r + vd)
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
    return total + expert_pairs * 6 * cfg["hidden_size"] * cfg["expert_ffn_hidden_size"]
