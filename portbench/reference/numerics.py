"""How the plain reference multiplies.

``Numerics("fp32")`` is the reference itself: every product in float32 with
TF32 off (``fp32()`` below turns it off for the block it guards).
``Numerics("fp8")`` is the control that `correct` must reject: the same
reference with the inputs of every weight product (both operands) rounded
to float8 e4m3 with an absmax scale per row of the activations and per
output column of the weight, the next precision below the bfloat16 that
the configurations state.  Attention's products and the softmax stay in
float32.  In the backward pass the rounding is passed through unchanged
(a straight-through estimate), so the control's gradients see the rounded
forward values and float32 incoming gradients.
"""
from __future__ import annotations

import contextlib

import torch

Tensor = torch.Tensor
E4M3_MAX = 448.0


@contextlib.contextmanager
def fp32():
    """Float32 products without TF32, restored afterwards."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _fp8(x: Tensor, dim: int) -> Tensor:
    """``x`` rounded to e4m3 with an absmax scale along ``dim`` (float32
    values out); the rounding is invisible to autograd."""
    s = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / E4M3_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x).detach()


class Numerics:
    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown reference precision {mode!r}")
        self.mode = mode

    def linear(self, x: Tensor, w_in_out: Tensor, b: Tensor | None = None) -> Tensor:
        """``x @ w (+ b)`` in float32, ``w`` stored ``[in, out]``."""
        x, w = x.float(), w_in_out.float()
        if self.mode == "fp8":
            x, w = _fp8(x, -1), _fp8(w, 0)
        y = x @ w
        return y if b is None else y + b.float()
