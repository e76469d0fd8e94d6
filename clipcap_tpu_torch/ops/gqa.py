"""Grouped-query attention of one beam decode step (Granite-4.0-H's
attention layers: 32 query heads over 8 K|V heads of 128, no rotation).

The cache holds, per sample and slot, one position's keys and values of
every K|V head: ``[R, slots, 2·Hkv·Dh]`` (K | V), in the beam layout of
``models/decoding.py`` (``decoding.beam_mask`` selects each beam's
ancestors).  Query head j reads K|V head ``j // (H / Hkv)``, as
``transformers``' ``repeat_kv``.

:func:`gqa_decode` is plain torch (two batched products and a float32
softmax over the slots ``[0, u_valid)``), as ``ops/mla.py::mla_decode``
is: four of Granite's forty layers over a caption's ≤ 77 positions are a
small share of a step.  Head size 128 and K|V groups in
``ops/flash_decode.py`` are a later change (``ROADMAP.md``, D10).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def gqa_decode(q: Tensor, cache: Tensor, mask: Tensor, u_valid: int, scale: float,
               kv_heads: int) -> Tensor:
    """``q`` [R, K, H, Dh], ``cache`` [R, slots, 2·Hkv·Dh] (K | V, ``kv_heads``
    Hkv), ``mask`` [R, K, slots] fp32 (0 or a large negative) → ``[R, K,
    H·Dh]``: per query head, softmax over slots ``[0, u_valid)`` of ``q·kᵀ ·
    scale + mask`` in float32, the weights rounded to q's dtype, times the
    slots' values."""
    R, K, H, Dh = q.shape
    G = H // kv_heads
    kv = cache[:, :u_valid].view(R, u_valid, 2, kv_heads, Dh)
    k = kv[:, :, 0].permute(0, 2, 3, 1)                                   # [R, Hkv, Dh, U]
    v = kv[:, :, 1].transpose(1, 2)                                       # [R, Hkv, U, Dh]
    qg = q.view(R, K, kv_heads, G, Dh).transpose(1, 2).reshape(R, kv_heads, K * G, Dh)
    s = torch.matmul(qg, k).float().view(R, kv_heads, K, G, u_valid) * scale
    s = s + mask[:, None, :, None, :u_valid]
    w = torch.softmax(s, dim=-1).to(q.dtype).view(R, kv_heads, K * G, u_valid)
    o = torch.matmul(w, v).view(R, kv_heads, K, G, Dh)                    # [R, Hkv, K, G, Dh]
    return o.transpose(1, 2).reshape(R, K, H * Dh)
