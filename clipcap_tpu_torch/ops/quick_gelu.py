"""OpenAI CLIP's QuickGELU, ``x · σ(1.702·x)``, as one elementwise pass.

Counterpart of ``clipcap_tpu/ops/layers.py::quick_gelu``, which XLA fuses.
Eager PyTorch runs the formula as three passes (the scale, the sigmoid,
the product): seven tensor-sized reads and writes where one read and one
write do.  The CUDA kernel is ``csrc/quick_gelu.cu``: one launch forward
and one backward, float32 inside and one rounding to ``x``'s dtype; the
backward recomputes the sigmoid from ``x``, the one tensor it saves.
:func:`quick_gelu_plain` and :func:`quick_gelu_backward_plain` are the
plain twins: the first is the CPU path, both are what the kernels are
held to.
"""
from __future__ import annotations

import torch

from clipcap_tpu_torch.ops import _build

Tensor = torch.Tensor

ALPHA = 1.702


def quick_gelu_plain(x: Tensor) -> Tensor:
    """The formula op by op, each op rounding to ``x``'s dtype."""
    return x * torch.sigmoid(ALPHA * x)


def quick_gelu_backward_plain(x: Tensor, dy: Tensor) -> Tensor:
    """``dy · (s + a·s·(1 − s))`` with ``a = 1.702·x`` and ``s = σ(a)``, in
    float32 and rounded once to ``x``'s dtype: the backward kernel's
    arithmetic."""
    a = ALPHA * x.float()
    s = torch.sigmoid(a)
    return (dy.float() * (s + a * (s * (1 - s)))).to(x.dtype)


def _launch(name: str, x: Tensor, *rest: Tensor) -> Tensor:
    """One launch of ``clipcap_<name>`` over ``x`` (and ``dy``) into a new
    tensor like ``x``, on ``x``'s device and its current stream."""
    for t in (x, *rest):
        if t.dtype not in _build.DTYPE_CODES:
            raise ValueError(f"{name}: the kernel takes bfloat16 or float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: needs contiguous tensors, got strides {t.stride()} "
                             f"for shape {tuple(t.shape)}")
        if t.dtype != x.dtype or t.shape != x.shape or t.device != x.device:
            raise ValueError(f"{name}: tensors differ: {t.dtype} {tuple(t.shape)} on "
                             f"{t.device} against {x.dtype} {tuple(x.shape)} on {x.device}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):      # the launch goes to the current device
        code = getattr(lib, f"clipcap_{name}")(x.data_ptr(), *(t.data_ptr() for t in rest),
                                               out.data_ptr(), x.numel(),
                                               _build.DTYPE_CODES[x.dtype],
                                               _build.stream_of(x))
    _build.check(code, name)
    quick_gelu.launches += 1
    return out


class QuickGELUFunction(torch.autograd.Function):
    """QuickGELU of a CUDA tensor under autograd: saves ``x`` alone; the
    backward is the second kernel."""

    @staticmethod
    def forward(ctx, x: Tensor) -> Tensor:
        ctx.save_for_backward(x)
        return _launch("quick_gelu", x)

    @staticmethod
    def backward(ctx, dy: Tensor) -> Tensor:
        (x,) = ctx.saved_tensors
        return _launch("quick_gelu_backward", x, dy.contiguous())


def quick_gelu(x: Tensor) -> Tensor:
    """``x · σ(1.702·x)`` in ``x``'s dtype.

    A CPU tensor takes :func:`quick_gelu_plain`.  A CUDA tensor (contiguous,
    bf16 or fp32) launches ``csrc/quick_gelu.cu`` once, out of place, or
    raises; under autograd through :class:`QuickGELUFunction`, whose
    backward is one launch more."""
    quick_gelu.calls += 1
    if x.device.type == "cpu":
        return quick_gelu_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quick_gelu: unsupported device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        return QuickGELUFunction.apply(x)
    return _launch("quick_gelu", x)


quick_gelu.calls = 0      # calls, on any device
quick_gelu.launches = 0   # kernel launches, forward and backward (one each on the card)
