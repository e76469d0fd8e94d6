"""Model FLOPs of a DeepSeek-V2 captioning batch, from the configuration.

Counted as ``flops.py`` counts (a product of ``[m, k]`` and ``[k, n]`` is
``2·m·k·n``; norms, the softmax, RoPE and lookups are not counted), over
the model's own forward as published: per position and layer, the query
projection, the latent projection, the decompression of the position's
keys and values (``kv_b_proj``), ``o_proj``, and the dense SwiGLU or the
router, the top-k routed experts and the shared experts (the active
parameters of a row, all layers); attention over ``c`` keys counts
``2·H·(q_head_dim + v_head_dim)·c`` per query; the untied head over the
whole vocabulary per logit row.  The absorbed decode the program runs
does other products; these are the model's.
"""
from __future__ import annotations

from portbench import flops


def positions(c: dict, n: float, attended: float, logit_rows: float) -> float:
    """``n`` query positions attending to ``attended`` keys in all, with
    ``logit_rows`` rows through the head."""
    D, H = c["hidden_size"], c["num_attention_heads"]
    nope, r, vd, C = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                      c["kv_lora_rank"])
    attn = 2 * D * H * (nope + r) + 2 * D * (C + r) + 2 * C * H * (nope + vd) + 2 * H * vd * D
    Fm = c["moe_intermediate_size"]
    moe = (2 * D * c["n_routed_experts"] + c["num_experts_per_tok"] * 6 * D * Fm
           + 6 * D * Fm * c["n_shared_experts"])
    dense = 6 * D * c["intermediate_size"]
    per_position = 0.0
    for i in range(c["num_hidden_layers"]):
        is_moe = i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0
        per_position += attn + (moe if is_moe else dense)
    per_key = c["num_hidden_layers"] * 2 * H * (nope + r + vd)
    return per_position * n + per_key * attended + 2 * D * c["vocab_size"] * logit_rows


def caption_batch(cfg: dict, batch: int, beam: int, decode_steps: int) -> float:
    """One beam-search batch, as ``flops.caption_batch``: the tower and
    mapper per image, the causal prefill of the P prefix positions with the
    last through the head, then ``decode_steps`` steps of ``batch·beam``
    rows, step s attending to its P + s positions."""
    P = cfg["mapper"]["prefix_length"]
    total = batch * (flops.vit_image(cfg["encoder"]) + flops.mapper_sample(cfg["mapper"]))
    total += positions(cfg, batch * P, batch * P * (P + 1) / 2, batch)
    rows = batch * beam
    for s in range(1, decode_steps + 1):
        total += positions(cfg, rows, rows * (P + s), rows)
    return total
