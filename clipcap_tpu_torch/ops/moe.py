"""Routed experts of a mixture-of-experts layer, grouped by expert.

A token's hidden state goes to its top-k experts (DeepSeek-V2: 6 of 64;
Kimi-Linear: 8 of 256, of which a layer may hold a share).
:func:`expert_groups` sorts the token-expert pairs by expert on the device
and gives each expert's rows as a device vector of offsets; the rows of
the pairs, gathered in that order, go through :func:`grouped_expert_mlp`
(each expert's SwiGLU on its own rows), and :func:`combine` weighs and sums
each token's k outputs.  No step of it reads a count on the host, so a
decode step around it can replay CUDA graphs.

:func:`grouped_expert_mlp` launches ``csrc/moe_grouped.cu`` for CUDA
tensors (two kernels: gate|up with SiLU·mul, then down; bf16, fp32
accumulation); :func:`grouped_expert_mlp_ref` is its plain per-expert twin,
used for CPU tensors and as the reference the kernels are held to.  It
replaces no TPU kernel: the JAX package runs no mixture-of-experts model.
Bytes bound it at a beam decode step; see the kernel's source for the
design.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from clipcap_tpu_torch.ops import _build

Tensor = torch.Tensor


def expert_groups(experts: Tensor, n_experts: int):
    """``experts`` [T, k] (each token's chosen experts) → ``(order, inv,
    offsets)``: ``order`` [T·k] the flat pair indices sorted by expert
    (stable: a token's pairs keep their order within an expert), ``inv``
    its inverse permutation, and ``offsets`` int32 [E + 1], expert e's
    pairs at ``[offsets[e], offsets[e + 1])`` of the sorted order."""
    flat = experts.reshape(-1)
    order = torch.argsort(flat, stable=True)
    bounds = torch.arange(n_experts + 1, device=flat.device, dtype=flat.dtype)
    offsets = torch.searchsorted(flat[order], bounds).to(torch.int32)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(order.numel(),
                                                                  device=order.device))
    return order, inv, offsets


def combine(y_sorted: Tensor, inv: Tensor, weights: Tensor) -> Tensor:
    """Each token's routed output: its k experts' rows (``y_sorted`` in the
    sorted pair order) weighed by ``weights`` [T, k] in float32 and summed,
    cast back to the rows' dtype (DeepSeek-V2's ``moe_infer``)."""
    T, k = weights.shape
    y = y_sorted.index_select(0, inv).view(T, k, -1)
    return (y.float() * weights[..., None]).sum(1).to(y_sorted.dtype)


def grouped_expert_mlp_ref(x: Tensor, w13: Tensor, w2: Tensor, offsets: Tensor) -> Tensor:
    """The plain twin: for each expert e with rows, ``h = silu(x·W1ᵀ) ⊙
    (x·W3ᵀ)`` from the fp32 products of its rows ``x[offsets[e]:offsets[e +
    1]]`` with ``w13[e]`` [2F, D] (W1 | W3), rounded to x's dtype, then
    ``h·w2[e]ᵀ`` in fp32, rounded to x's dtype: the kernels' arithmetic.
    Rows past ``offsets[E]`` are not read; their outputs are zero here and
    unwritten by the kernels."""
    Fw = w2.shape[-1]
    out = torch.zeros(x.shape[0], w2.shape[1], dtype=x.dtype, device=x.device)
    bounds = offsets.tolist()
    for e in range(w13.shape[0]):
        lo, hi = bounds[e], bounds[e + 1]
        if lo == hi:
            continue
        gu = x[lo:hi].float() @ w13[e].float().t()
        h = (F.silu(gu[:, :Fw]) * gu[:, Fw:]).to(x.dtype)
        out[lo:hi] = (h.float() @ w2[e].float().t()).to(x.dtype)
    return out


def _fail(what: str):
    raise ValueError(f"grouped_expert_mlp: {what}")


def grouped_expert_mlp(x: Tensor, w13: Tensor, w2: Tensor, offsets: Tensor) -> Tensor:
    """Each expert's SwiGLU over its rows of ``x`` [M, D] (sorted by expert,
    expert e's at ``[offsets[e], offsets[e + 1])``; ``offsets`` int32
    [E + 1] on x's device, ``offsets[E] ≤ M``) with the stacked weights
    ``w13`` [E, 2F, D] (gate | up) and ``w2`` [E, D, F] → ``[M, D]``.
    Rows past ``offsets[E]`` belong to no expert held here (a layer that
    holds a share of its experts gets a fixed M, whatever lands here): they
    are never read, and their output rows are left as they are (unwritten
    on the card, zero from the twin).

    A CPU tensor goes to the twin; a CUDA tensor launches the two kernels
    of ``csrc/moe_grouped.cu`` (bf16, contiguous, D a multiple of 128 and F
    of 64) or raises."""
    grouped_expert_mlp.calls += 1
    grouped_expert_mlp.rows += x.shape[0]
    if x.device.type == "cpu":
        return grouped_expert_mlp_ref(x, w13, w2, offsets)
    M, D = x.shape
    E, F2, D1 = w13.shape
    Fw = F2 // 2
    if (D1 != D or w2.shape != (E, D, Fw) or offsets.shape != (E + 1,)
            or offsets.dtype != torch.int32):
        _fail(f"shapes x {tuple(x.shape)}, w13 {tuple(w13.shape)}, w2 {tuple(w2.shape)}, "
              f"offsets {offsets.dtype}{tuple(offsets.shape)} do not fit")
    if not all(t.dtype == torch.bfloat16 for t in (x, w13, w2)):
        _fail("the kernels take bf16 rows and weights")
    if D % 128 or Fw % 64:
        _fail(f"needs D % 128 == 0 and F % 64 == 0, got D={D}, F={Fw}")
    if not all(t.is_contiguous() and t.device == x.device for t in (x, w13, w2, offsets)):
        _fail("tensors must be contiguous and on one device")
    if any(t.data_ptr() % 16 for t in (x, w13, w2)):
        _fail("rows and weights must be 16-byte aligned")
    h = torch.empty(M, Fw, dtype=x.dtype, device=x.device)
    y = torch.empty(M, D, dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    lib = _build.load_library()
    stream = _build.stream_of(x)
    with torch.cuda.device(x.device):
        _build.check(lib.clipcap_moe_gate_up(x.data_ptr(), w13.data_ptr(), offsets.data_ptr(),
                                             h.data_ptr(), E, D, Fw, stream),
                     "clipcap_moe_gate_up")
        _build.check(lib.clipcap_moe_down(h.data_ptr(), w2.data_ptr(), offsets.data_ptr(),
                                          y.data_ptr(), E, Fw, D, stream), "clipcap_moe_down")
    grouped_expert_mlp.launches += 2
    return y


grouped_expert_mlp.calls = 0      # calls, on any device
grouped_expert_mlp.rows = 0       # token-expert rows over all calls (host ints, from shapes)
grouped_expert_mlp.launches = 0   # kernel launches (two a call on the card)
