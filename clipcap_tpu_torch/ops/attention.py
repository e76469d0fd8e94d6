"""Encoder attention: the packed-qkv kernel and the unfused form.

Counterpart of ``clipcap_tpu/ops/attention.py``.  :func:`sdpa_packed`
reads q/k/v straight from the packed ``[B, N, 3D]`` in_proj output and
returns ``[B, N, D]`` ready for out_proj; on CUDA it is one launch of
``csrc/sdpa_packed.cu`` for every row length (no fallback), and
:func:`sdpa_packed_ref` is its plain twin.  :func:`sdpa` is the unfused
attention with an optional additive bias, plain PyTorch as in the JAX
package.
"""
from __future__ import annotations

from typing import Optional

import torch

from clipcap_tpu_torch.ops import _build

Tensor = torch.Tensor

HEAD_DIM = 64  # the kernel's head_dim (every CLIP preset)


def _split_heads(qkv: Tensor, heads: int):
    B, N, threeD = qkv.shape
    D = threeD // 3
    if threeD != 3 * D or D % heads:
        raise ValueError(f"sdpa_packed: last dim {threeD} is not 3·heads·Dh "
                         f"for heads={heads}")
    q, k, v = (t.reshape(B, N, heads, D // heads) for t in qkv.split(D, dim=-1))
    return q, k, v


def sdpa_packed_ref(qkv: Tensor, heads: int, *, scale: Optional[float] = None,
                    causal: bool = False) -> Tensor:
    """Plain PyTorch twin of the packed kernel: fp32 logits and softmax,
    weights cast to the input dtype, value product accumulated in fp32."""
    q, k, v = _split_heads(qkv, heads)
    B, N, H, Dh = q.shape
    s = Dh ** -0.5 if scale is None else scale
    logits = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * s
    if causal:
        hidden = torch.ones(N, N, dtype=torch.bool, device=qkv.device).triu(1)
        logits = logits.masked_fill(hidden, float("-inf"))
    w = torch.softmax(logits, dim=-1).to(qkv.dtype)
    out = torch.einsum("bhnm,bmhd->bnhd", w.float(), v.float())
    return out.reshape(B, N, H * Dh).to(qkv.dtype)


def sdpa_packed(qkv: Tensor, heads: int, *, scale: Optional[float] = None,
                causal: bool = False) -> Tensor:
    """Fused attention middle over the packed qkv projection → [B, N, D].

    A CPU tensor goes to the twin; a CUDA tensor launches
    ``csrc/sdpa_packed.cu`` (bf16 or fp32, Dh = 64, any N) or raises."""
    if qkv.device.type == "cpu":
        return sdpa_packed_ref(qkv, heads, scale=scale, causal=causal)
    B, N, threeD = qkv.shape
    D = threeD // 3
    if qkv.device.type != "cuda":
        raise ValueError(f"sdpa_packed: unsupported device {qkv.device}")
    if qkv.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"sdpa_packed: needs bf16 or fp32, got {qkv.dtype}")
    if threeD != 3 * D or D != heads * HEAD_DIM:
        raise ValueError(f"sdpa_packed: needs Dh={HEAD_DIM}, got qkv "
                         f"{tuple(qkv.shape)} with heads={heads}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("sdpa_packed: qkv must be contiguous and 16-byte aligned")
    s = HEAD_DIM ** -0.5 if scale is None else scale
    lib = _build.load_library()
    out = torch.empty((B, N, D), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):   # the launch goes to the current device
        code = lib.clipcap_sdpa_packed(
            qkv.data_ptr(), out.data_ptr(), B, N, heads, int(causal),
            _build.DTYPE_CODES[qkv.dtype], s, _build.stream_of(qkv))
    _build.check(code, "sdpa_packed")
    sdpa_packed.launches += 1
    return out


sdpa_packed.launches = 0


def sdpa(q: Tensor, k: Tensor, v: Tensor, *, scale: Optional[float] = None,
         causal: bool = False, bias: Optional[Tensor] = None) -> Tensor:
    """Unfused attention over ``[B, N, H, Dh]`` q/k/v (optional additive
    bias) → ``[B, N, H·Dh]``; the JAX package's ``sdpa(fused=False)``."""
    B, N, H, Dh = q.shape
    s = Dh ** -0.5 if scale is None else scale
    logits = (torch.einsum("bnhd,bmhd->bhnm", q, k) * s).float()
    if causal:
        hidden = torch.ones(N, N, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(hidden, -1e9)
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(B, N, H * Dh)
