"""One decode step of a Mamba-2 mixer (the state-space layers of
Granite-4.0-H) for rows whose state each continues another row's (a
beam's parent).

Per row b, with p = ``parent[b]``, H heads of P channels, a state of N per
channel and one group (B and C shared by all heads):

* the causal depthwise convolution of kernel 4 over the xBC channels
  (``x`` H·P | ``B`` N | ``C`` N): the parent's last three inputs and the
  row's new one, weighted by the taps, plus the bias, then SiLU; the row's
  window (its last three inputs) is written to ``conv_dst[b]``;
* per head h: ``dt = softplus(dt_raw + dt_bias)`` (no clamp), ``A =
  −exp(A_log)``; the state h ∈ ℝ^{P×N} read from ``s_src[p]``: ``h ←
  exp(dt·A)·h + dt·x ⊗ B`` in float32, rounded to the state's dtype into
  ``s_dst[b]``; ``y = h·C + D·x`` from the float32 state.

A parent of −1 starts from a zero state and a zero window (a sequence's
first position).  The beam reorder is this read by parent: no state is
gathered or copied apart from the step.

:func:`mamba_decode` launches ``csrc/mamba_decode.cu`` for CUDA tensors
(P = 64, N = 128; bf16 or fp32, the state in the inputs' dtype) and
raises on what it does not take; :func:`mamba_decode_ref` is its plain
twin, used for CPU tensors and as what the kernel is held to.  It replaces
no TPU kernel: the JAX package runs no state-space model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from clipcap_tpu_torch.ops import _build

Tensor = torch.Tensor

CONV_TAPS = 4           # the convolution's kernel (mamba_d_conv)
HEAD = 64               # the kernel's head size (mamba_d_head)
STATE = 128             # the kernel's state size (mamba_d_state)


def mamba_decode_ref(xbc: Tensor, dt: Tensor, conv_w: Tensor, conv_b: Tensor, A_log: Tensor,
                     D: Tensor, dt_bias: Tensor, parent: Tensor, conv_src: Tensor,
                     conv_dst: Tensor, s_src: Tensor, s_dst: Tensor,
                     beam_size: int = 1) -> Tensor:
    """The plain twin of :func:`mamba_decode`, in float32 throughout, the
    state and the output rounded to their dtypes: the kernel's arithmetic."""
    B, C = xbc.shape
    H, P, N = s_src.shape[1:]
    p = parent.long()
    fresh = p < 0
    pc = p.clamp_min(0)
    past = conv_src.index_select(0, pc).float().masked_fill(fresh.view(B, 1, 1), 0.0)
    window = torch.cat([past, xbc.float()[:, None]], dim=1)                   # [B, 4, C]
    taps = conv_w.reshape(C, CONV_TAPS).float().t()
    y = F.silu((window * taps[None]).sum(1) + conv_b.float())                # [B, C]
    conv_dst[:B] = window[:, 1:].to(conv_dst.dtype)
    x, Bm, Cm = y.split([H * P, N, N], dim=-1)
    x = x.view(B, H, P)
    step = F.softplus(dt.float() + dt_bias.float())                          # [B, H]
    decay = torch.exp(-step * A_log.float().exp())
    S = s_src.index_select(0, pc).float().masked_fill(fresh.view(B, 1, 1, 1), 0.0)
    S = S * decay[..., None, None] + (step[..., None] * x)[..., None] * Bm[:, None, None]
    s_dst[:B] = S.to(s_dst.dtype)
    out = torch.einsum("bhpn,bn->bhp", S, Cm) + D.float()[:, None] * x
    return out.reshape(B, H * P).to(xbc.dtype)


def _fail(what: str):
    raise ValueError(f"mamba_decode: {what}")


def mamba_decode(xbc: Tensor, dt: Tensor, conv_w: Tensor, conv_b: Tensor, A_log: Tensor,
                 D: Tensor, dt_bias: Tensor, parent: Tensor, conv_src: Tensor,
                 conv_dst: Tensor, s_src: Tensor, s_dst: Tensor,
                 beam_size: int = 1) -> Tensor:
    """One Mamba-2 step of B rows → ``y`` [B, H·P] in xbc's dtype.

    ``xbc`` [B, H·P + 2N]: the step's x | B | C before the convolution
    (any row stride, unit inside a row); ``dt`` [B, H]: the raw step before
    ``dt_bias`` (any row stride); ``conv_w`` [H·P + 2N, 1, 4] or [·, 4] and
    ``conv_b`` [H·P + 2N]: the convolution's taps and bias; ``A_log``,
    ``D``, ``dt_bias`` [H]; ``parent`` int32 [B] on xbc's device (−1: zero
    state); ``conv_src``/``conv_dst`` [≥ B, 3, H·P + 2N] (the last three
    inputs); ``s_src``/``s_dst`` [≥ B, H, P, N].  Every tensor but the
    parents in xbc's dtype.  Row b writes ``conv_dst[b]`` and ``s_dst[b]``;
    the sources are only read.  On the card, the rows are ``beam_size``
    beams a sample, blocks of one parent's children side by side.

    A CPU tensor goes to the twin; a CUDA tensor launches the kernel (P =
    64, N = 128, bf16 or fp32) or raises."""
    mamba_decode.calls += 1
    mamba_decode.rows += xbc.shape[0]
    if xbc.device.type == "cpu":
        return mamba_decode_ref(xbc, dt, conv_w, conv_b, A_log, D, dt_bias, parent, conv_src,
                                conv_dst, s_src, s_dst, beam_size)
    B, C = xbc.shape
    if s_src.dim() != 4 or s_dst.shape[1:] != s_src.shape[1:]:
        _fail(f"states must be [rows, H, P, N], got {tuple(s_src.shape)}, {tuple(s_dst.shape)}")
    H, P, N = s_src.shape[1:]
    if P != HEAD or N != STATE or C != H * P + 2 * N:
        _fail(f"the kernel takes heads of {HEAD}, a state of {STATE} and one group, got "
              f"H={H}, P={P}, N={N}, channels {C}")
    dtype = xbc.dtype
    if dtype not in (torch.bfloat16, torch.float32):
        _fail(f"xbc must be bf16 or fp32, got {dtype}")
    w = conv_w.reshape(C, CONV_TAPS)
    vectors = (conv_b, A_log, D, dt_bias)
    if any(t.dtype != dtype for t in (dt, w, *vectors, conv_src, conv_dst, s_src, s_dst)):
        _fail("every tensor but the parents must have xbc's dtype")
    if parent.dtype != torch.int32 or parent.shape != (B,):
        _fail(f"parent must be int32 [B], got {parent.dtype}{tuple(parent.shape)}")
    if xbc.stride(1) != 1 or dt.shape != (B, H) or dt.stride(1) != 1:
        _fail("xbc and dt must be [B, ·] with unit stride inside a row")
    if conv_b.shape != (C,) or any(t.shape != (H,) for t in vectors[1:]):
        _fail("conv_b must be [channels] and A_log, D, dt_bias [H]")
    if (conv_src.shape[1:] != (CONV_TAPS - 1, C) or conv_dst.shape[1:] != (CONV_TAPS - 1, C)
            or min(conv_dst.shape[0], s_dst.shape[0]) < B):
        _fail("windows must be [rows, 3, channels] and states [rows, H, P, N], rows ≥ B")
    tensors = (xbc, dt, w, *vectors, parent, conv_src, conv_dst, s_src, s_dst)
    if not all(t.device == xbc.device for t in tensors):
        _fail("tensors must be on one device")
    if not all(t.is_contiguous() for t in (w, *vectors, parent, conv_src, conv_dst, s_src, s_dst)):
        _fail("taps, vectors, parents, windows and states must be contiguous")
    if s_src.data_ptr() % 16 or s_dst.data_ptr() % 16:
        _fail("states must be 16-byte aligned")
    if B % beam_size:
        _fail(f"{B} rows are not whole samples of {beam_size} beams")
    y = torch.empty(B, H * P, dtype=dtype, device=xbc.device)
    if B == 0:
        return y
    lib = _build.load_library()
    with torch.cuda.device(xbc.device):
        _build.check(lib.clipcap_mamba_decode(
            xbc.data_ptr(), xbc.stride(0), dt.data_ptr(), dt.stride(0), w.data_ptr(),
            conv_b.data_ptr(), A_log.data_ptr(), D.data_ptr(), dt_bias.data_ptr(),
            parent.data_ptr(), conv_src.data_ptr(), conv_dst.data_ptr(), s_src.data_ptr(),
            s_dst.data_ptr(), y.data_ptr(), B, H, beam_size, _build.DTYPE_CODES[dtype],
            _build.stream_of(xbc)), "clipcap_mamba_decode")
    mamba_decode.launches += 1
    return y


mamba_decode.calls = 0      # calls, on any device
mamba_decode.rows = 0       # rows over all calls (host ints, from shapes)
mamba_decode.launches = 0   # kernel launches (one a call on the card)
