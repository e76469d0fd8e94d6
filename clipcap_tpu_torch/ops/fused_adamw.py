"""Fused AdamW: one pass over every parameter tensor, in place.

Counterpart of ``clipcap_tpu/ops/fused_adamw.py::fused_adamw`` (selected by
``--fused-optimizer true``).  The CUDA kernel is ``csrc/fused_adamw.cu``: one
launch per optimizer step over all tensors, reading p, g, m, v and writing
p, m, v.  :func:`fused_adamw_ref` is its plain PyTorch twin, used for CPU
tensors and as the reference the kernel is held to.

The JAX kernel returns the optax delta ``-lr·(m̂/(√v̂+eps) + wd·p)`` and
``optax.apply_updates`` adds it; here the delta is added in place.  Both
forms take the seven fp32 scalars of the JAX kernel, computed on the host
by :func:`adamw_scalars`.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from clipcap_tpu_torch.ops import _build

Tensor = torch.Tensor


def adamw_scalars(lr, b1: float, b2: float, eps: float, weight_decay: float,
                  count: int) -> tuple:
    """``(lr, b1, b2, eps, wd, 1-b1^t, 1-b2^t)`` as float32 values (held in
    Python floats, exactly), with ``t`` the 1-based step ``count`` — the
    JAX kernel's scalar row, computed in float32 in its order."""
    f = np.float32
    t = f(count)
    return tuple(float(x) for x in (f(lr), f(b1), f(b2), f(eps), f(weight_decay),
                                    f(1) - f(b1) ** t, f(1) - f(b2) ** t))


def adamw_(params: Sequence[Tensor], grads: Sequence[Tensor], exp_avgs: Sequence[Tensor],
           exp_avg_sqs: Sequence[Tensor], scalars, one_minus_b1: float,
           one_minus_b2: float) -> None:
    """AdamW with decoupled weight decay as separate tensor ops in optax's
    order, updating params and moments in place.  Each op rounds on its
    own: no ``alpha=`` and no fused multiply-add.  The bias corrections are
    divided as tensors, because CUDA divides by a Python scalar through
    its reciprocal."""
    lr, b1, b2, eps, wd, bc1, bc2 = scalars
    if not params:
        return
    bc1_t, bc2_t = (torch.full((), bc, dtype=torch.float32, device=params[0].device)
                    for bc in (bc1, bc2))
    for p, g, m, v in zip(params, grads, exp_avgs, exp_avg_sqs, strict=True):
        m.mul_(b1).add_(g * one_minus_b1)
        v.mul_(b2).add_((g * g) * one_minus_b2)
        m_hat = m / bc1_t
        v_hat = v / bc2_t
        u = m_hat / (v_hat.sqrt() + eps) + p * wd
        p.add_(u * -lr)


def fused_adamw_ref(params: Sequence[Tensor], grads: Sequence[Tensor],
                    exp_avgs: Sequence[Tensor], exp_avg_sqs: Sequence[Tensor],
                    scalars) -> None:
    """Plain PyTorch twin of the kernel.  ``1 - b`` is taken in float32
    from the float32 ``b``, as the JAX kernel takes it."""
    b1, b2 = np.float32(scalars[1]), np.float32(scalars[2])
    adamw_(params, grads, exp_avgs, exp_avg_sqs, scalars,
           float(np.float32(1) - b1), float(np.float32(1) - b2))


def _table(tensors: Sequence[Sequence[Tensor]], device) -> Tensor:
    """The kernel's int64 table: the p, g, m, v pointer rows, then the
    prefix sums of the element counts."""
    params = tensors[0]
    offsets = np.concatenate([[0], np.cumsum([p.numel() for p in params])])
    rows = [t.data_ptr() for group in tensors for t in group]
    host = torch.tensor(rows + offsets.tolist(), dtype=torch.int64).pin_memory()
    return host.to(device, non_blocking=True)


def fused_adamw(params: Sequence[Tensor], grads: Sequence[Tensor], exp_avgs: Sequence[Tensor],
                exp_avg_sqs: Sequence[Tensor], scalars) -> None:
    """One AdamW step over every tensor, in place.

    ``scalars`` is :func:`adamw_scalars`'s row.  CPU tensors go to the
    twin; CUDA tensors (contiguous fp32, p/g/m/v of equal shapes, one
    device) launch ``csrc/fused_adamw.cu`` once, or raise.
    """
    groups = (list(params), list(grads), list(exp_avgs), list(exp_avg_sqs))
    n = len(groups[0])
    if any(len(g) != n for g in groups):
        raise ValueError(f"fused_adamw: {[len(g) for g in groups]} params/grads/moments")
    if n == 0:
        return
    dev = groups[0][0].device
    if dev.type == "cpu":
        return fused_adamw_ref(*groups, scalars)
    if dev.type != "cuda":
        raise ValueError(f"fused_adamw: unsupported device {dev}")
    for p, g, m, v in zip(*groups):
        for t in (p, g, m, v):
            if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                raise ValueError(f"fused_adamw: needs contiguous fp32 tensors on {dev}, "
                                 f"got {t.dtype} on {t.device} (contiguous "
                                 f"{t.is_contiguous()})")
        if not p.shape == g.shape == m.shape == v.shape:
            raise ValueError(f"fused_adamw: shapes p{tuple(p.shape)} g{tuple(g.shape)} "
                             f"m{tuple(m.shape)} v{tuple(v.shape)}")
    total = sum(p.numel() for p in groups[0])
    if total == 0:
        return
    table = _table(groups, dev)
    lib = _build.load_library()
    with torch.cuda.device(dev):      # the launch goes to the current device
        code = lib.clipcap_fused_adamw(table.data_ptr(), n, total, *scalars,
                                       _build.stream_of(table))
    _build.check(code, "fused_adamw")
    fused_adamw.launches += 1


fused_adamw.launches = 0
