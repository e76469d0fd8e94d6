"""Encoder attention: the packed-qkv and head-major kernels, and the façade.

Counterpart of ``clipcap_tpu/ops/attention.py``.  Both kernels are entry
points of one attention core, ``csrc/sdpa.cu`` (tensor cores for bf16,
CUDA cores for fp32), and differ only in how they address q, k, v and the
output:

- :func:`sdpa_packed` reads q/k/v straight from the packed ``[B, N, 3D]``
  in_proj output and returns ``[B, N, D]`` ready for out_proj (any N);
- :func:`fused_sdpa` takes head-major ``[B, H, N, Dh]`` q, k, v (N ≤ 512,
  as the JAX kernel) and returns the same layout.

Each has a plain twin (:func:`sdpa_packed_ref`, :func:`fused_sdpa_ref`)
that a CPU tensor reaches; a CUDA tensor launches the kernel or raises.
:func:`sdpa` is the JAX package's façade: ``fused_sdpa`` where it applies,
else the unfused einsum form with an optional additive bias.
"""
from __future__ import annotations

from typing import Optional

import torch

from clipcap_tpu_torch.ops import _build

Tensor = torch.Tensor

HEAD_DIM = 64  # the kernels' head_dim (every CLIP preset)
FUSED_MAX_N = 512  # the JAX fused_sdpa's whole-row limit
_NEG = -1e9


def _split_heads(qkv: Tensor, heads: int):
    B, N, threeD = qkv.shape
    D = threeD // 3
    if threeD != 3 * D or D % heads:
        raise ValueError(f"sdpa_packed: last dim {threeD} is not 3·heads·Dh "
                         f"for heads={heads}")
    q, k, v = (t.reshape(B, N, heads, D // heads) for t in qkv.split(D, dim=-1))
    return q, k, v


def _check_cuda(name: str, tensors, heads_dim: int) -> None:
    """What the CUDA core takes: bf16 or fp32 on one CUDA device, Dh = 64,
    contiguous and 16-byte aligned."""
    first = tensors[0]
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    if first.dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: needs bf16 or fp32, got {first.dtype}")
    if heads_dim != HEAD_DIM:
        raise ValueError(f"{name}: needs Dh={HEAD_DIM}, got {heads_dim}")
    for t in tensors:
        if t.device != first.device or t.dtype != first.dtype:
            raise ValueError(f"{name}: operands on different devices or dtypes")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be contiguous and 16-byte aligned")


def sdpa_packed_ref(qkv: Tensor, heads: int, *, scale: Optional[float] = None,
                    causal: bool = False) -> Tensor:
    """Plain PyTorch twin of the packed kernel: :func:`fused_sdpa_ref` on
    the heads of the packed projection (fp32 logits and softmax, weights
    cast to the input dtype, value product accumulated in fp32)."""
    B, N, threeD = qkv.shape
    q, k, v = (t.transpose(1, 2) for t in _split_heads(qkv, heads))
    out = fused_sdpa_ref(q, k, v, scale=scale, causal=causal)
    return out.transpose(1, 2).reshape(B, N, threeD // 3)


def sdpa_packed(qkv: Tensor, heads: int, *, scale: Optional[float] = None,
                causal: bool = False) -> Tensor:
    """Fused attention middle over the packed qkv projection → [B, N, D].

    A CPU tensor goes to the twin; a CUDA tensor launches
    ``csrc/sdpa.cu`` (bf16 or fp32, Dh = 64, any N) or raises."""
    if qkv.device.type == "cpu":
        return sdpa_packed_ref(qkv, heads, scale=scale, causal=causal)
    B, N, threeD = qkv.shape
    D = threeD // 3
    if threeD != 3 * D or D % heads:
        raise ValueError(f"sdpa_packed: needs Dh={HEAD_DIM}, got qkv "
                         f"{tuple(qkv.shape)} with heads={heads}")
    _check_cuda("sdpa_packed", [qkv], D // heads)
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


def fused_sdpa_ref(q: Tensor, k: Tensor, v: Tensor, *, scale: Optional[float] = None,
                   causal: bool = False) -> Tensor:
    """Plain PyTorch twin of the head-major kernel, as the JAX
    ``_sdpa_kernel``: fp32 logits, hidden keys at -1e9, the weights
    normalised in fp32 and cast to the input dtype, an fp32 value product."""
    N, Dh = q.shape[-2:]
    s = Dh ** -0.5 if scale is None else scale
    logits = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * s
    if causal:
        hidden = torch.ones(N, N, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(hidden, _NEG)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bhmd->bhnd", w.float(), v.float()).to(q.dtype)


def fused_sdpa(q: Tensor, k: Tensor, v: Tensor, *, scale: Optional[float] = None,
               causal: bool = False) -> Tensor:
    """Attention over head-major ``[B, H, N, Dh]`` q/k/v → ``[B, H, N, Dh]``
    for N ≤ 512.

    A CPU tensor goes to the twin; a CUDA tensor launches ``csrc/sdpa.cu``
    (bf16 or fp32, Dh = 64, contiguous) or raises."""
    B, H, N, Dh = q.shape
    if N > FUSED_MAX_N:
        raise ValueError(f"fused_sdpa supports N<={FUSED_MAX_N}, got {N}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_sdpa: q, k, v shapes differ: {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.device.type == "cpu":
        return fused_sdpa_ref(q, k, v, scale=scale, causal=causal)
    _check_cuda("fused_sdpa", [q, k, v], Dh)
    s = Dh ** -0.5 if scale is None else scale
    lib = _build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = lib.clipcap_fused_sdpa(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, N, int(causal),
            _build.DTYPE_CODES[q.dtype], s, _build.stream_of(q))
    _build.check(code, "fused_sdpa")
    fused_sdpa.launches += 1
    return out


fused_sdpa.launches = 0


def sdpa(q: Tensor, k: Tensor, v: Tensor, *, scale: Optional[float] = None,
         causal: bool = False, bias: Optional[Tensor] = None, fused: bool = True) -> Tensor:
    """Attention over ``[B, N, H, Dh]`` q/k/v → ``[B, N, H·Dh]``, the JAX
    package's façade: with ``fused``, no bias and N ≤ 512 it goes through
    :func:`fused_sdpa` (head-major copies in, the context back), else the
    unfused einsum form with an optional additive bias."""
    B, N, H, Dh = q.shape
    if fused and bias is None and N <= FUSED_MAX_N:
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        o = fused_sdpa(qt, kt, vt, scale=scale, causal=causal)
        return o.transpose(1, 2).reshape(B, N, H * Dh)

    s = Dh ** -0.5 if scale is None else scale
    logits = (torch.einsum("bnhd,bmhd->bhnm", q, k) * s).float()
    if causal:
        hidden = torch.ones(N, N, dtype=torch.bool, device=q.device).triu(1)
        logits = logits.masked_fill(hidden, _NEG)
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(B, N, H * Dh)
