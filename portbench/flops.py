"""Model FLOPs of the benchmark's work, from the configuration alone.

A product of an ``[m, k]`` and a ``[k, n]`` matrix counts ``2·m·k·n``;
attention over ``c`` keys counts ``4·d·c`` per query (``q·kᵀ`` and ``w·v``);
norms, activations, softmax and the embedding lookups are not counted.
The counts are the models' own forward passes as published (OpenAI CLIP's
``encode_image`` over every row of every block, ClipCap's mapper over its
projection and prefix tokens, GPT-2 per position), whatever the program
skips or recomputes.
"""
from __future__ import annotations


def vit_image(e: dict) -> float:
    """One image through the CLIP ViT tower to its embedding."""
    D, p, L = e["width"], e["patch_size"], e["layers"]
    n = (e["image_size"] // p) ** 2
    N = n + 1
    return 2 * n * 3 * p * p * D + L * (24 * N * D * D + 4 * N * N * D) + 2 * D * e["embed_dim"]


def mapper_sample(m: dict) -> float:
    """One embedding through the transformer mapper to its prefix."""
    D, E, L = m["lm_embedding_size"], m["encoder_embedding_size"], m["num_layers"]
    T = m["projection_length"] + m["prefix_length"]
    F = int(D * m["mlp_ratio"])
    per_layer = 2 * T * D * D + 4 * T * D * D + 2 * T * D * D + 4 * T * D * F + 4 * T * T * D
    return 2 * E * m["projection_length"] * D + L * per_layer


def gpt2_positions(c: dict, positions: float, attended: float, logit_rows: float) -> float:
    """GPT-2 over ``positions`` query positions that attend to ``attended``
    keys in all (summed over the queries), with ``logit_rows`` rows through
    the LM head."""
    D, L = c["n_embd"], c["n_layer"]
    return (L * (24 * D * D * positions + 4 * D * attended)
            + 2 * D * c["vocab_size"] * logit_rows)


def caption_batch(cfg: dict, batch: int, beam: int, decode_steps: int) -> float:
    """One beam-search batch: the tower and mapper per image, the prefill of
    the P prefix positions (causal) with the last through the LM head, then
    ``decode_steps`` steps of ``batch·beam`` rows, step s at position
    P + s - 1 attending to its P + s positions, each row through the head."""
    P = cfg["mapper"]["prefix_length"]
    lm = cfg["language_model"]
    total = batch * (vit_image(cfg["encoder"]) + mapper_sample(cfg["mapper"]))
    total += gpt2_positions(lm, batch * P, batch * P * (P + 1) / 2, batch)
    rows = batch * beam
    for s in range(1, decode_steps + 1):
        total += gpt2_positions(lm, rows, rows * (P + s), rows)
    return total


def train_step(cfg: dict, batch: int, tokens: int, train_lm: bool) -> float:
    """One training step: the forward (mapper, GPT-2 over P + T positions,
    causal, T rows through the head), the backward to every activation
    (each product again, attention twice), and the weight gradients of what
    is trained (each of its products once more)."""
    P = cfg["mapper"]["prefix_length"]
    lm = cfg["language_model"]
    S = P + tokens
    mapper = batch * mapper_sample(cfg["mapper"])
    body = gpt2_positions(lm, batch * S, 0, 0)
    attn = gpt2_positions(lm, 0, batch * S * (S + 1) / 2, 0)
    head = gpt2_positions(lm, 0, 0, batch * tokens)
    lm_weights = body + head if train_lm else 0
    return 3 * mapper + 2 * body + 3 * attn + 2 * head + lm_weights
