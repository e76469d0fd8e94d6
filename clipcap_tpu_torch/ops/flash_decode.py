"""Flash-decode attention: one KV-cached decode step over the interleaved
K|V cache.

Counterpart of ``clipcap_tpu/ops/flash_decode.py``: :func:`flash_decode`
(a bf16/fp32 cache, or int8 rows with per-slot scales; per-row slot bounds;
the online-softmax carry in and out) and :func:`flash_decode_two_phase`
(one softmax over a consolidated shared-prefix cache, then the live beam
cache).  Both launch ``csrc/flash_decode.cu`` for CUDA tensors;
:func:`flash_decode_ref` and :func:`flash_decode_two_phase_ref` are their
plain PyTorch twins, used for CPU tensors and as the reference the kernels
are held to.

Semantics (kernel and twin): fp32 logits ``q·kᵀ/√Dh``, for an int8 cache
times the slot's k-scale, plus the additive fp32 mask; an fp32 online
softmax; for an int8 cache the weights times the slot's v-scale; the value
product accumulated in fp32 and the output cast to q's dtype.  Only slots
``[lo, hi)`` of each row are contracted and read, so the caller's mask
need not cover the others.  The twins round the softmax weights to q's
dtype before the value product, as the Pallas kernel does; the CUDA kernel
keeps them in fp32 (bf16 outputs differ by up to ~2e-2 at O(1)).

A bound is a host int (the decode loops know the step on the host) or a
device int32 ``[R]`` vector (one bound per row, e.g. each sample's
converged length); the kernel reads the vector itself, so neither form
costs a device-to-host copy.  The carry is ``(m, l, acc)``: the running max
and sum ``[R, H, K]`` and the unnormalised V accumulator ``[R, H, K, Dh]``,
all fp32 (the JAX package carries ``acc`` over both halves of the
interleaved row; its ``[..., Dh:]`` is this one).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from clipcap_tpu_torch.ops import _build

Tensor = torch.Tensor
Bound = Union[int, Tensor, None]
Carry = Tuple[Tensor, Tensor, Tensor]

HEAD_DIM = 64       # the kernel's head_dim (every GPT-2 preset)
MAX_QUERIES = 8     # the kernel's bound on K (queries per row and head)
INT8_SLOT_QUANTUM = 128   # int8 caches hold a multiple of this many slots


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def _fresh(q: Tensor) -> Carry:
    R, H, K, Dh = q.shape
    m = torch.full((R, H, K), float("-inf"), device=q.device)
    return m, torch.zeros_like(m), torch.zeros((R, H, K, Dh), device=q.device)


def _attend_ref(q: Tensor, kv: Tensor, mask: Tensor, lo: Bound, hi: Bound,
                scales: Optional[Tuple[Tensor, Tensor]], carry: Optional[Carry]) -> Carry:
    """Fold slots ``[lo, hi)`` of each row into the softmax state ``carry``
    (fresh when None) → the new ``(m, l, acc)``."""
    R, H, K, Dh = q.shape
    U = kv.shape[2]
    m0, l0, acc0 = _fresh(q) if carry is None else carry
    per_row = isinstance(lo, Tensor) or isinstance(hi, Tensor)
    # Host bounds slice the window; per-row bounds take the whole buffer and
    # hide each row's slots outside its own bounds.
    a, b = (0, U) if per_row else (max(int(lo), 0), min(int(hi), U))
    if b <= a:
        return m0, l0, acc0
    k = kv[:, :, a:b, :Dh].float()          # int8 and bf16 widen exactly
    v = kv[:, :, a:b, Dh:].float()
    logits = torch.matmul(q.float(), k.transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    if scales is not None:
        logits = logits * scales[0][:, :, None, a:b]
    logits = logits + mask[:, None, :, a:b].float()          # [R, H, K, n]
    if per_row:
        slot = torch.arange(a, b, device=q.device)
        lo_r = torch.as_tensor(lo, device=q.device).reshape(-1, 1)
        hi_r = torch.as_tensor(hi, device=q.device).reshape(-1, 1)
        inside = (slot >= lo_r) & (slot < hi_r)                # [R or 1, n]
        logits = logits.masked_fill(~inside[:, None, None, :], float("-inf"))
    m = torch.maximum(m0, logits.amax(dim=-1))
    m_use = torch.where(m == float("-inf"), 0.0, m)          # rows with nothing visible
    alpha = torch.exp(m0 - m_use)
    w = torch.exp(logits - m_use[..., None])
    l = l0 * alpha + w.sum(dim=-1)
    if scales is not None:
        w = w * scales[1][:, :, None, a:b]
    acc = acc0 * alpha[..., None] + torch.matmul(w.to(q.dtype).float(), v)
    return m, l, acc


def _normalise(q: Tensor, state: Carry) -> Tensor:
    _, l, acc = state
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


def flash_decode_ref(q: Tensor, kv: Tensor, mask: Tensor, u_valid: Bound = None,
                     scales: Optional[Tuple[Tensor, Tensor]] = None, u_lo: Bound = None,
                     carry: Optional[Carry] = None, return_carry: bool = False):
    """Plain PyTorch decode attention.

    q: [R, H, K, Dh]; kv: [R, H, U, 2·Dh] (K in ``[..., :Dh]``, V in
    ``[..., Dh:]``), bf16/fp32 as q or int8 rows with ``scales = (sk, sv)``
    fp32 [R, H, U]; mask: [Rm, K, U] fp32 additive, Rm ∈ {1, R}; slots
    ``[u_lo, u_valid)`` (None → 0 and U).  → [R, H, K, Dh] in q's dtype,
    or the ``(m, l, acc)`` partials with ``return_carry``.
    """
    state = _attend_ref(q, kv, mask, 0 if u_lo is None else u_lo,
                        kv.shape[2] if u_valid is None else u_valid, scales, carry)
    return state if return_carry else _normalise(q, state)


def flash_decode_two_phase_ref(q: Tensor, shared: Tensor, shared_mask: Tensor, live: Tensor,
                               live_mask: Tensor, sh_valid: Bound, lv_lo: Bound,
                               lv_valid: Bound, shared_scales=None, live_scales=None) -> Tensor:
    """Plain two-phase decode attention: shared slots ``[0, sh_valid)``
    then live slots ``[lv_lo, lv_valid)``, one softmax.  Shapes as
    :func:`flash_decode_ref` per region (masks [Rm, K, U] of their own)."""
    part = _attend_ref(q, shared, shared_mask, 0, sh_valid, shared_scales, None)
    return _normalise(q, _attend_ref(q, live, live_mask, lv_lo, lv_valid, live_scales, part))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _fail(name: str, what: str):
    raise ValueError(f"{name}: {what}")


def _check_region(name: str, q: Tensor, kv: Tensor, mask: Tensor, scales) -> Tuple[int, int]:
    """Validate one cache region against q → (U, Rm)."""
    R, H, K, Dh = q.shape
    U = kv.shape[2] if kv.dim() == 4 else -1
    if kv.shape != (R, H, U, 2 * Dh):
        _fail(name, f"kv{tuple(kv.shape)} does not match q{tuple(q.shape)}")
    if scales is None:
        if kv.dtype != q.dtype:
            _fail(name, f"q/kv must share bf16 or fp32, got {q.dtype}/{kv.dtype} "
                  "(an int8 cache needs its scales)")
    else:
        if kv.dtype != torch.int8:
            _fail(name, f"scales given for a {kv.dtype} cache")
        if U % INT8_SLOT_QUANTUM:
            _fail(name, f"an int8 cache holds a multiple of {INT8_SLOT_QUANTUM} slots, got {U}")
        for s in scales:
            if (s.shape != (R, H, U) or s.dtype != torch.float32 or not s.is_contiguous()
                    or s.device != q.device):
                _fail(name, f"scales must be contiguous fp32 [R, H, U] on {q.device}")
    Rm = mask.shape[0]
    if mask.shape[1:] != (K, U) or Rm not in (1, R) or mask.dtype != torch.float32:
        _fail(name, f"mask must be fp32 [1 or R, K, U], got {mask.dtype}{tuple(mask.shape)}")
    if not (kv.is_contiguous() and mask.is_contiguous()):
        _fail(name, "kv and mask must be contiguous")
    if kv.data_ptr() % 16:
        _fail(name, "kv must be 16-byte aligned (16-byte loads)")
    if not kv.device == mask.device == q.device:
        _fail(name, "q, kv, mask must share a device")
    return U, Rm


def _check_q(name: str, q: Tensor) -> None:
    if q.device.type != "cuda":
        _fail(name, f"unsupported device {q.device}")
    R, H, K, Dh = q.shape
    if q.dtype not in _build.DTYPE_CODES:
        _fail(name, f"q must be bf16 or fp32, got {q.dtype}")
    if Dh != HEAD_DIM or not 1 <= K <= MAX_QUERIES:
        _fail(name, f"needs Dh={HEAD_DIM} and 1<=K<={MAX_QUERIES}, got Dh={Dh} K={K}")
    if not q.is_contiguous():
        _fail(name, "q must be contiguous")


def _bound(name: str, b: Bound, default: int, U: int, q: Tensor):
    """A bound → (device pointer or None, host value)."""
    if b is None:
        return None, default
    if isinstance(b, Tensor):
        if (b.shape != (q.shape[0],) or b.dtype != torch.int32 or b.device != q.device
                or not b.is_contiguous()):
            _fail(name, f"a per-row bound must be a contiguous int32 [R] tensor on {q.device}")
        return b.data_ptr(), 0
    if not 0 <= int(b) <= U:
        _fail(name, f"bound {int(b)} outside [0, {U}]")
    return None, int(b)


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def flash_decode(q: Tensor, kv: Tensor, mask: Tensor, u_valid: Bound = None,
                 scales: Optional[Tuple[Tensor, Tensor]] = None, u_lo: Bound = None,
                 carry: Optional[Carry] = None, return_carry: bool = False):
    """One decode step of masked attention over an interleaved KV cache.

    Arguments as :func:`flash_decode_ref`.  A CPU tensor goes to the twin;
    a CUDA tensor launches ``csrc/flash_decode.cu`` (q bf16 or fp32, the
    cache as q or int8, Dh = 64, K ≤ 8) or raises.
    """
    if q.device.type == "cpu":
        return flash_decode_ref(q, kv, mask, u_valid, scales, u_lo, carry, return_carry)
    name = "flash_decode"
    _check_q(name, q)
    U, Rm = _check_region(name, q, kv, mask, scales)
    R, H, K, Dh = q.shape
    lo_ptr, lo = _bound(name, u_lo, 0, U, q)
    hi_ptr, hi = _bound(name, u_valid, U, U, q)
    if carry is not None:
        for t, shape in zip(carry, ((R, H, K), (R, H, K), (R, H, K, Dh))):
            if (t.shape != shape or t.dtype != torch.float32 or not t.is_contiguous()
                    or t.device != q.device):
                _fail(name, "carry must be contiguous fp32 (m, l [R, H, K], acc [R, H, K, Dh])")
    lib = _build.load_library()
    if return_carry:
        out = None
        state = _fresh(q)
    else:
        out = torch.empty_like(q)
        state = (None, None, None)
    c_in = (None, None, None) if carry is None else carry
    sk, sv = (None, None) if scales is None else scales
    with torch.cuda.device(q.device):     # the launch goes to the current device
        code = lib.clipcap_flash_decode(
            q.data_ptr(), kv.data_ptr(), _ptr(sk), _ptr(sv), mask.data_ptr(), _ptr(out),
            *(_ptr(t) for t in c_in), *(_ptr(t) for t in state), lo_ptr, hi_ptr,
            R, H, K, U, Rm, lo, hi, _build.DTYPE_CODES[q.dtype], 1.0 / math.sqrt(Dh),
            _build.stream_of(q))
    _build.check(code, name)
    flash_decode.launches += 1
    if scales is not None:
        flash_decode.int8_launches += 1
    return state if return_carry else out


flash_decode.launches = 0          # every launch of the single-phase kernel
flash_decode.int8_launches = 0     # of which over an int8 cache


def flash_decode_two_phase(q: Tensor, shared: Tensor, shared_mask: Tensor, live: Tensor,
                           live_mask: Tensor, sh_valid: Bound, lv_lo: Bound, lv_valid: Bound,
                           shared_scales=None, live_scales=None) -> Tensor:
    """Decode attention over a consolidated shared prefix plus the live
    beam region: one launch, one softmax.

    q: [R, H, K, Dh]; shared: [R, H, Us, 2·Dh] (one slot per position) with
    ``shared_mask`` [Rm, K, Us]; live: [R, H, Ul, 2·Dh] (time-major beam
    slots) with ``live_mask`` [Rm, K, Ul], which must hide the positions the
    shared region serves.  Each region bf16/fp32 as q, or int8 with its
    ``(sk, sv)`` scales.  Slots ``[0, sh_valid)`` of the shared region and
    ``[lv_lo, lv_valid)`` of the live one; each bound a host int or a
    device int32 ``[R]`` vector.  → [R, H, K, Dh] in q's dtype.  A CPU
    tensor goes to the twin; a CUDA tensor launches the kernel or raises.
    """
    if q.device.type == "cpu":
        return flash_decode_two_phase_ref(q, shared, shared_mask, live, live_mask, sh_valid,
                                          lv_lo, lv_valid, shared_scales, live_scales)
    name = "flash_decode_two_phase"
    _check_q(name, q)
    Us, sRm = _check_region(name, q, shared, shared_mask, shared_scales)
    Ul, lRm = _check_region(name, q, live, live_mask, live_scales)
    R, H, K, Dh = q.shape
    sh_ptr, sh = _bound(name, sh_valid, Us, Us, q)
    lo_ptr, lo = _bound(name, lv_lo, 0, Ul, q)
    hi_ptr, hi = _bound(name, lv_valid, Ul, Ul, q)
    ssk, ssv = (None, None) if shared_scales is None else shared_scales
    lsk, lsv = (None, None) if live_scales is None else live_scales
    lib = _build.load_library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        code = lib.clipcap_flash_decode_two_phase(
            q.data_ptr(), shared.data_ptr(), _ptr(ssk), _ptr(ssv), shared_mask.data_ptr(), Us,
            sRm, sh_ptr, sh, live.data_ptr(), _ptr(lsk), _ptr(lsv), live_mask.data_ptr(), Ul,
            lRm, lo_ptr, lo, hi_ptr, hi, out.data_ptr(), R, H, K, _build.DTYPE_CODES[q.dtype],
            1.0 / math.sqrt(Dh), _build.stream_of(q))
    _build.check(code, name)
    flash_decode_two_phase.launches += 1
    return out


flash_decode_two_phase.launches = 0
