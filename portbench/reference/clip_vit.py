"""Plain CLIP ViT image tower (OpenAI ``VisionTransformer.forward``).

Weights come as a dict under OpenAI's keys (``visual.conv1.weight``,
``visual.transformer.resblocks.{i}.attn.in_proj_weight``, ...), in float32.
Departures from OpenAI's code: the stride-p convolution is written as a
patch reshape and a product (the same sum), and the uint8 → [0, 1] →
normalised pixels step of CLIP's host transform is done here on the
tensor, since the images arrive as uint8 arrays already cropped.
"""
from __future__ import annotations

import torch

from portbench.reference.numerics import Numerics

Tensor = torch.Tensor
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


def layer_norm(x: Tensor, w: Tensor, b: Tensor, eps: float = 1e-5) -> Tensor:
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def _attention(x: Tensor, W: dict, pre: str, heads: int, num: Numerics) -> Tensor:
    """``nn.MultiheadAttention(x, x, x)`` with its packed in-projection."""
    B, N, D = x.shape
    qkv = num.linear(x, W[pre + "in_proj_weight"].t(), W[pre + "in_proj_bias"])
    q, k, v = (t.reshape(B, N, heads, D // heads).transpose(1, 2) for t in qkv.split(D, -1))
    w = torch.softmax((q @ k.transpose(-1, -2)) * (D // heads) ** -0.5, dim=-1)
    o = (w @ v).transpose(1, 2).reshape(B, N, D)
    return num.linear(o, W[pre + "out_proj.weight"].t(), W[pre + "out_proj.bias"])


def vit_encode(W: dict, images: Tensor, cfg: dict, num: Numerics) -> Tensor:
    """uint8 ``[B, H, W, 3]`` images → ``[B, embed_dim]`` float32."""
    p, D, heads = cfg["patch_size"], cfg["width"], cfg["heads"]
    mean = torch.tensor(MEAN, device=images.device)
    std = torch.tensor(STD, device=images.device)
    x = (images.float() / 255.0 - mean) / std                          # [B, H, W, 3]
    B, H, Wd, _ = x.shape
    x = x.reshape(B, H // p, p, Wd // p, p, 3).permute(0, 1, 3, 5, 2, 4)
    x = x.reshape(B, (H // p) * (Wd // p), 3 * p * p)                  # rows (c, ph, pw)
    conv = W["visual.conv1.weight"].reshape(D, 3 * p * p)
    x = num.linear(x, conv.t())
    cls = W["visual.class_embedding"].float().expand(B, 1, D)
    x = torch.cat([cls, x], dim=1) + W["visual.positional_embedding"].float()
    x = layer_norm(x, W["visual.ln_pre.weight"], W["visual.ln_pre.bias"])
    for i in range(cfg["layers"]):
        pre = f"visual.transformer.resblocks.{i}."
        x = x + _attention(layer_norm(x, W[pre + "ln_1.weight"], W[pre + "ln_1.bias"]),
                           W, pre + "attn.", heads, num)
        h = layer_norm(x, W[pre + "ln_2.weight"], W[pre + "ln_2.bias"])
        h = num.linear(h, W[pre + "mlp.c_fc.weight"].t(), W[pre + "mlp.c_fc.bias"])
        h = h * torch.sigmoid(1.702 * h)                               # QuickGELU
        x = x + num.linear(h, W[pre + "mlp.c_proj.weight"].t(), W[pre + "mlp.c_proj.bias"])
    x = layer_norm(x[:, 0], W["visual.ln_post.weight"], W["visual.ln_post.bias"])
    return num.linear(x, W["visual.proj"])
