"""Plain ClipCap ``TransformerMapper`` (Mokady et al., ``train.py``).

``linear`` projects the embedding to ``projection_length`` tokens, the
learned ``prefix_const`` follows them, the transformer (pre-norm layers,
ClipCap's fused key/value attention, a ReLU MLP of ``mlp_ratio``) runs over
both, and the outputs at the prefix_const positions are the LM prefix.
Weights under the reference's state-dict keys, float32.  Dropout is 0, as
at inference and in the port.
"""
from __future__ import annotations

import torch

from portbench.reference.clip_vit import layer_norm
from portbench.reference.numerics import Numerics

Tensor = torch.Tensor


def mapper_prefix(W: dict, emb: Tensor, cfg: dict, num: Numerics) -> Tensor:
    """``[B, E]`` embeddings → ``[B, prefix_length, D]`` float32."""
    D, H = cfg["lm_embedding_size"], cfg["num_heads"]
    Pj, P = cfg["projection_length"], cfg["prefix_length"]
    B = emb.shape[0]
    x = num.linear(emb, W["linear.weight"].t(), W["linear.bias"]).reshape(B, Pj, D)
    x = torch.cat([x, W["prefix_const"].float().expand(B, P, D)], dim=1)
    for i in range(cfg["num_layers"]):
        pre = f"transformer.layers.{i}."
        h = layer_norm(x, W[pre + "norm1.weight"], W[pre + "norm1.bias"])
        n = h.shape[1]
        q = num.linear(h, W[pre + "attn.to_queries.weight"].t()).reshape(B, n, H, D // H)
        kv = num.linear(h, W[pre + "attn.to_keys_values.weight"].t()).reshape(B, n, 2, H, D // H)
        k, v = kv[:, :, 0], kv[:, :, 1]
        att = torch.einsum("bnhd,bmhd->bnmh", q, k) * (D // H) ** -0.5
        att = torch.softmax(att, dim=2)
        o = torch.einsum("bnmh,bmhd->bnhd", att, v).reshape(B, n, D)
        x = x + num.linear(o, W[pre + "attn.project.weight"].t(), W[pre + "attn.project.bias"])
        h = layer_norm(x, W[pre + "norm2.weight"], W[pre + "norm2.bias"])
        h = torch.relu(num.linear(h, W[pre + "mlp.fc1.weight"].t(), W[pre + "mlp.fc1.bias"]))
        x = x + num.linear(h, W[pre + "mlp.fc2.weight"].t(), W[pre + "mlp.fc2.bias"])
    return x[:, Pj:]
