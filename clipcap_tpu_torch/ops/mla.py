"""Latent attention of one beam decode step (DeepSeek-V2's MLA, absorbed).

The cache holds, per sample and slot, the normalised latent ``c`` (rank C)
and the roped shared key ``k_pe`` (r values): ``[R, slots, C + r]``, in
the beam layout of ``models/decoding.py`` (``decoding.beam_mask`` selects
each beam's ancestors).  With the up-projections absorbed into the query
(``q_lat = q_nope·W_UKᵀ`` per head, beside the roped ``q_pe``), a head's
score is one dot product with the cached row and its output the weighted
sum of the latents; ``W_UV`` and ``o_proj`` follow outside.

:func:`mla_decode` is plain torch for now (two batched products and a
float32 softmax over the slots ``[0, u_valid)``); a hand kernel is a
later change (``ROADMAP.md``, D8).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def mla_decode(q: Tensor, cache: Tensor, mask: Tensor, u_valid: int, scale: float,
               rank: int) -> Tensor:
    """``q`` [R, K, H, C + r] (absorbed query | roped ``q_pe``), ``cache``
    [R, slots, C + r], ``mask`` [R, K, slots] fp32 (0 or a large negative)
    → ``[R, K, H, C]``: softmax over slots ``[0, u_valid)`` of ``q·rowᵀ ·
    scale + mask``, in float32, the weights rounded to q's dtype, times the
    slots' latents ``row[:C]`` (C = ``rank``)."""
    R, K, H, Dq = q.shape
    kv = cache[:, :u_valid]                                           # [R, U, C + r]
    s = torch.matmul(q.reshape(R, K * H, Dq), kv.transpose(1, 2))     # [R, K·H, U]
    s = s.float().view(R, K, H, u_valid) * scale + mask[:, :, None, :u_valid]
    w = torch.softmax(s, dim=-1).to(q.dtype).view(R, K * H, u_valid)
    return torch.matmul(w, kv[..., :rank]).view(R, K, H, rank)
