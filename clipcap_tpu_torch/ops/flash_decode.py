"""Flash-decode attention: one KV-cached decode step over the interleaved
K|V cache.

Counterpart of ``clipcap_tpu/ops/flash_decode.py::flash_decode`` in its
bf16/fp32 form with a scalar ``u_valid``.  The CUDA kernel is
``csrc/flash_decode.cu``; :func:`flash_decode_ref` is its plain PyTorch
twin, used for CPU tensors and as the reference the kernel is held to.

Semantics (both forms): fp32 logits ``q·kᵀ/√Dh`` plus the additive fp32
mask, an fp32 softmax, the value product accumulated in fp32 and the
output cast to q's dtype.  Only slots ``[0, u_valid)`` are contracted; the
slots past it are never read, so the caller's mask need not cover them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from clipcap_tpu_torch.ops import _build

Tensor = torch.Tensor

HEAD_DIM = 64      # the kernel's head_dim (every GPT-2 preset)
MAX_QUERIES = 8    # the kernel's bound on K (queries per row and head)


def flash_decode_ref(q: Tensor, kv: Tensor, mask: Tensor,
                     u_valid: Optional[int] = None) -> Tensor:
    """Plain PyTorch decode attention.

    q: [R, H, K, Dh]; kv: [R, H, U, 2·Dh] (K in ``[..., :Dh]``, V in
    ``[..., Dh:]``); mask: [Rm, K, U] fp32 additive, Rm ∈ {1, R};
    u_valid: slots written so far (None → all U).  → [R, H, K, Dh].
    """
    R, H, K, Dh = q.shape
    u = kv.shape[2] if u_valid is None else int(u_valid)
    k = kv[:, :, :u, :Dh].float()
    v = kv[:, :, :u, Dh:]
    logits = torch.matmul(q.float(), k.transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    logits = logits + mask[:, None, :, :u].float()          # [Rm, 1, K, u]
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w.float(), v.float()).to(q.dtype)


def flash_decode(q: Tensor, kv: Tensor, mask: Tensor,
                 u_valid: Optional[int] = None) -> Tensor:
    """One decode step of masked attention over an interleaved KV cache.

    Shapes as :func:`flash_decode_ref`.  A CPU tensor goes to the twin; a
    CUDA tensor launches ``csrc/flash_decode.cu`` (bf16 or fp32, Dh = 64,
    K ≤ 8) or raises.  ``u_valid`` is a host int: the decode loops know
    the step on the host.
    """
    if q.device.type == "cpu":
        return flash_decode_ref(q, kv, mask, u_valid)
    R, H, K, Dh = q.shape
    U = kv.shape[2]
    u = U if u_valid is None else int(u_valid)
    Rm = mask.shape[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    if q.dtype not in _build.DTYPE_CODES or kv.dtype != q.dtype:
        raise ValueError(f"flash_decode: q/kv must share bf16 or fp32, got "
                         f"{q.dtype}/{kv.dtype}")
    if Dh != HEAD_DIM or not 1 <= K <= MAX_QUERIES:
        raise ValueError(f"flash_decode: needs Dh={HEAD_DIM} and 1<=K<="
                         f"{MAX_QUERIES}, got Dh={Dh} K={K}")
    if kv.shape != (R, H, U, 2 * Dh) or mask.shape[1:] != (K, U) or Rm not in (1, R):
        raise ValueError(f"flash_decode: shapes q{tuple(q.shape)} "
                         f"kv{tuple(kv.shape)} mask{tuple(mask.shape)}")
    if mask.dtype != torch.float32 or not 0 <= u <= U:
        raise ValueError(f"flash_decode: mask must be fp32 and 0<=u_valid<=U "
                         f"(mask {mask.dtype}, u_valid {u}, U {U})")
    if not (q.is_contiguous() and kv.is_contiguous() and mask.is_contiguous()):
        raise ValueError("flash_decode: q, kv and mask must be contiguous")
    if kv.data_ptr() % 16:
        raise ValueError("flash_decode: kv must be 16-byte aligned (16-byte loads)")
    if not (kv.device == q.device == mask.device):
        raise ValueError("flash_decode: q, kv and mask must share a device")
    lib = _build.load_library()
    out = torch.empty_like(q)
    code = lib.clipcap_flash_decode(
        q.data_ptr(), kv.data_ptr(), mask.data_ptr(), out.data_ptr(),
        R, H, K, U, Rm, u, _build.DTYPE_CODES[q.dtype], 1.0 / math.sqrt(Dh),
        _build.stream_of(q))
    _build.check(code, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0
