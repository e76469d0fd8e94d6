"""One decode step of Kimi Delta Attention (KDA), the gated delta rule of
Kimi-Linear's linear-attention layers, for rows whose state each continues
another row's (a beam's parent).

Per row b, head h (head size d), with p = ``parent[b]``:

* the short convolutions: for each of q, k, v, the depthwise causal
  convolution of kernel 4 over the parent's last three inputs and the
  row's new one, then SiLU; the row's window (its last three inputs) is
  written to ``conv_dst[b]``;
* q and k L2-normalised over the head (``x / sqrt(Σx² + eps)``), q scaled
  by d^-1/2;
* the state S ∈ ℝ^{d×d} (float32, rows indexed by the key channel) read
  from ``s_src[p]``: ``S ← Diag(exp g) S``; ``S ← S + β k (v − Sᵀk)ᵀ``;
  written to ``s_dst[b]``; the output ``o = Sᵀ q``.

A parent of −1 starts from a zero state and a zero window (a sequence's
first position).  The beam reorder is this read by parent: no state is
gathered or copied apart from the step.

:func:`kda_decode` launches ``csrc/kda_decode.cu`` for CUDA tensors (d =
128; bf16 or fp32 inputs; float32 state) and raises on what it does not
take; :func:`kda_decode_ref` is its plain twin, used for CPU tensors and as
what the kernel is held to.  It replaces no TPU kernel: the JAX package
runs no linear-attention model.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from clipcap_tpu_torch.ops import _build

Tensor = torch.Tensor

CONV_TAPS = 4           # the short convolutions' kernel
L2_EPS = 1e-6           # eps of q's and k's L2 norm (inside the root)


def kda_decode_ref(q: Tensor, k: Tensor, v: Tensor, wq: Tensor, wk: Tensor, wv: Tensor,
                   g: Tensor, beta: Tensor, parent: Tensor, conv_src: Tensor,
                   conv_dst: Tensor, s_src: Tensor, s_dst: Tensor, beam_size: int = 1,
                   eps: float = L2_EPS) -> Tensor:
    """The plain twin of :func:`kda_decode`, in float32 throughout, the
    outputs rounded to q's dtype: the kernel's arithmetic."""
    B, HD = q.shape
    H, d = g.shape[1], g.shape[2]
    p = parent.long()
    fresh = (p < 0).view(B, 1, 1, 1)
    pc = p.clamp_min(0)
    past = conv_src.index_select(0, pc).float().masked_fill(fresh, 0.0)   # [B, 3, 3, HD]
    x = torch.stack([q, k, v], dim=1).float()                            # [B, 3, HD]
    window = torch.cat([past, x[:, :, None]], dim=2)                     # [B, 3, 4, HD]
    taps = torch.stack([wq, wk, wv]).float().reshape(3, HD, CONV_TAPS).transpose(1, 2)
    y = F.silu((window * taps[None]).sum(2))                             # [B, 3, HD]
    conv_dst[:B] = window[:, :, 1:].to(conv_dst.dtype)
    qh, kh, vh = (y[:, m].view(B, H, d) for m in range(3))
    qh = qh * torch.rsqrt(qh.pow(2).sum(-1, keepdim=True) + eps) * d ** -0.5
    kh = kh * torch.rsqrt(kh.pow(2).sum(-1, keepdim=True) + eps)
    S = s_src.index_select(0, pc).masked_fill(fresh, 0.0) * g.float().exp()[..., None]
    u = (vh - torch.einsum("bhij,bhi->bhj", S, kh)) * beta.float()[..., None]
    S = S + kh[..., None] * u[..., None, :]
    s_dst[:B] = S
    return torch.einsum("bhij,bhi->bhj", S, qh).to(q.dtype)


def _fail(what: str):
    raise ValueError(f"kda_decode: {what}")


def kda_decode(q: Tensor, k: Tensor, v: Tensor, wq: Tensor, wk: Tensor, wv: Tensor,
               g: Tensor, beta: Tensor, parent: Tensor, conv_src: Tensor, conv_dst: Tensor,
               s_src: Tensor, s_dst: Tensor, beam_size: int = 1,
               eps: float = L2_EPS) -> Tensor:
    """One KDA step of B rows → ``o`` [B, H, d] in q's dtype.

    ``q``, ``k``, ``v`` [B, H·d]: the step's projections, before their
    convolutions (one row stride, unit stride inside a row); ``wq``,
    ``wk``, ``wv`` [H·d, 1, 4] or [H·d, 4]: the convolutions' taps; ``g``
    [B, H, d] float32 log decay (``−exp(A_log)·softplus(·)``); ``beta`` [B,
    H] float32; ``parent`` int32 [B] on q's device (−1: zero state);
    ``conv_src``/``conv_dst`` [≥ B, 3, 3, H·d] in q's dtype (q, k, v's last
    three inputs); ``s_src``/``s_dst`` [≥ B, H, d, d] float32.  Row b writes
    ``conv_dst[b]`` and ``s_dst[b]``; the sources are only read.  On the
    card, the rows are ``beam_size`` beams a sample, blocks of one parent's
    children side by side.

    A CPU tensor goes to the twin; a CUDA tensor launches the kernel (d =
    128, bf16 or fp32) or raises."""
    kda_decode.calls += 1
    kda_decode.rows += q.shape[0]
    if q.device.type == "cpu":
        return kda_decode_ref(q, k, v, wq, wk, wv, g, beta, parent, conv_src, conv_dst,
                              s_src, s_dst, beam_size, eps)
    B, HD = q.shape
    if g.dim() != 3 or g.shape[0] != B:
        _fail(f"g must be [B, H, d], got {tuple(g.shape)}")
    H, d = g.shape[1], g.shape[2]
    if d != 128 or H * d != HD:
        _fail(f"the kernel takes heads of 128, got H={H}, d={d}, H·d={HD}")
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32):
        _fail(f"q must be bf16 or fp32, got {dt}")
    ws = [w.reshape(HD, 4) for w in (wq, wk, wv)]
    if any(t.dtype != dt for t in (k, v, conv_src, conv_dst, *ws)):
        _fail("q, k, v, the taps and the windows must share one dtype")
    if any(t.dtype != torch.float32 for t in (g, beta, s_src, s_dst)):
        _fail("g, beta and the state must be float32")
    if parent.dtype != torch.int32 or parent.shape != (B,):
        _fail(f"parent must be int32 [B], got {parent.dtype}{tuple(parent.shape)}")
    if k.stride() != q.stride() or v.stride() != q.stride() or q.stride(1) != 1:
        _fail("q, k, v must share a row stride, unit inside a row")
    if g.stride()[1:] != (d, 1) or beta.shape != (B, H) or beta.stride(1) != 1:
        _fail("g and beta must be contiguous inside a row")
    if (conv_src.shape[1:] != (3, 3, HD) or conv_dst.shape[1:] != (3, 3, HD)
            or s_src.shape[1:] != (H, d, d) or s_dst.shape[1:] != (H, d, d)
            or min(conv_dst.shape[0], s_dst.shape[0]) < B):
        _fail("windows must be [rows, 3, 3, H·d] and states [rows, H, d, d], rows ≥ B")
    tensors = (q, k, v, *ws, g, beta, parent, conv_src, conv_dst, s_src, s_dst)
    if not all(t.device == q.device for t in tensors):
        _fail("tensors must be on one device")
    if not all(t.is_contiguous() for t in (*ws, parent, conv_src, conv_dst, s_src, s_dst)):
        _fail("taps, parents, windows and states must be contiguous")
    if s_src.data_ptr() % 16 or s_dst.data_ptr() % 16:
        _fail("states must be 16-byte aligned")
    if B % beam_size:
        _fail(f"{B} rows are not whole samples of {beam_size} beams")
    o = torch.empty(B, H, d, dtype=dt, device=q.device)
    if B == 0:
        return o
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        _build.check(lib.clipcap_kda_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(0),
            ws[0].data_ptr(), ws[1].data_ptr(), ws[2].data_ptr(),
            g.data_ptr(), g.stride(0), beta.data_ptr(), beta.stride(0), parent.data_ptr(),
            conv_src.data_ptr(), conv_dst.data_ptr(), s_src.data_ptr(), s_dst.data_ptr(),
            o.data_ptr(), B, H, beam_size, _build.DTYPE_CODES[dt], float(eps),
            float(d ** -0.5), _build.stream_of(q)), "clipcap_kda_decode")
    kda_decode.launches += 1
    return o


kda_decode.calls = 0      # calls, on any device
kda_decode.rows = 0       # rows over all calls (host ints, from shapes)
kda_decode.launches = 0   # kernel launches (one a call on the card)
