"""Core functional layers shared by every model of the port.

Counterpart of ``clipcap_tpu/ops/layers.py``.  Parameters live in
``nn.Module``s; the compute dtype is the dtype of the tensors handed in
(float32 for parity runs, bfloat16 for serving) and weights are cast to
it.  Layer norm runs in float32 whatever the input dtype, as in the JAX
package.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clipcap_tpu_torch.ops.quick_gelu import quick_gelu

Tensor = torch.Tensor


def round_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``n``."""
    return (n + m - 1) // m * m


def gelu_new(x: Tensor) -> Tensor:
    """GPT-2's tanh-approximated GELU (HF ``gelu_new``, ``jax.nn.gelu``'s
    default): ``0.5·x·(1 + tanh(√(2/π)·(x + 0.044715·x³)))``.

    One ATen ``gelu``: one launch, float32 inside and one rounding to
    ``x``'s dtype; under autograd one fused ``gelu_backward`` that saves
    only ``x``."""
    return F.gelu(x, approximate="tanh")


def relu(x: Tensor) -> Tensor:
    return torch.clamp_min(x, 0)


ACTIVATIONS = {
    "gelu_new": gelu_new,
    "quick_gelu": quick_gelu,
    "gelu": gelu_new,  # jax.nn.gelu's default
    "relu": relu,
}


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the trailing dim: normalised and scaled in float32,
    returned in the dtype of ``x``.

    One ATen ``layer_norm``: one launch, and its fused backward under
    autograd.  Weights of ``x``'s dtype go in as they are (ATen widens a
    bf16 ``x`` and its weights to float32 inside the kernel).  Weights of
    another dtype are never rounded to ``x``'s: CUDA's kernel takes one
    dtype, so ``x`` is widened to float32 and the result cast back."""
    shape = (x.shape[-1],)
    if scale.dtype == x.dtype and bias.dtype == x.dtype:
        return F.layer_norm(x, shape, scale, bias, eps)
    return F.layer_norm(x.float(), shape, scale.float(), bias.float(), eps).to(x.dtype)


class Int8Weight(nn.Module):
    """A projection weight in the JAX package's int8 ``{"q", "s"}`` form
    (``ops.quant.quantize_linear``): ``w ≈ q · s`` with int8 ``q`` and fp32
    per-output-channel scales ``s`` [out].  ``q`` keeps the layout of the
    weight it replaces: ``[in, out]`` for a ``Conv1D``, ``[out, in]``
    (``out_in``) for a ``Linear`` layout; :meth:`in_out` is the ``[in, out]``
    view either way (column-major for ``out_in``)."""

    def __init__(self, q: Tensor, s: Tensor, out_in: bool):
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.out_in = out_in

    def in_out(self) -> Tensor:
        return self.q.t() if self.out_in else self.q


def linear(x: Tensor, w, b: Optional[Tensor] = None) -> Tensor:
    """``x @ w (+ b)`` with ``w`` stored ``[in, out]`` (HF ``Conv1D``
    layout) and cast to the dtype of ``x``.

    ``w`` may also be an :class:`Int8Weight` (weight-only int8, w8a16): as
    in the JAX package, ``q`` is widened to the compute dtype, and the
    per-channel scale, cast to the product's dtype, applies to the output
    (``x @ q·diag(s) == (x @ q)·s``).  XLA fuses the widening into the
    dot; eager PyTorch writes a widened copy of ``q`` on every call.

    A bias with a dense ``w`` goes into the product: one ``addmm`` over
    ``x``'s rows, which CUDA runs as one cuBLASLt GEMM whose epilogue adds
    the bias to the fp32 accumulator before the output is rounded (no
    broadcast add after it).  ``w`` keeps its layout: cuBLAS reads the
    ``.t()`` view of a ``Linear`` weight as it is."""
    linear.calls += 1
    if isinstance(w, Int8Weight):
        y = x @ w.in_out().to(x.dtype)
        y = y * w.s.to(y.dtype)
        return y if b is None else y + b.to(y.dtype)
    if b is None:
        return x @ w.to(x.dtype)
    linear.bias_in_gemm += 1
    n_in, n_out = w.shape
    y = torch.addmm(b.to(x.dtype), x.reshape(-1, n_in), w.to(x.dtype))
    return y.reshape(*x.shape[:-1], n_out)


linear.calls = 0          # calls, on any device
linear.bias_in_gemm = 0   # calls whose bias went into the GEMM (a dense weight)


def embed(table: Tensor, ids: Tensor, dtype: torch.dtype) -> Tensor:
    """Embedding lookup, cast to the compute dtype."""
    return F.embedding(ids.long(), table).to(dtype)


# Parameter holders.  Weights arrive from a parameter tree
# (``clipcap_tpu_torch.convert``), so they start empty.  They start frozen;
# training turns ``requires_grad`` on for what it trains
# (``train.state.create_train_state``).


def empty_param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape), requires_grad=False)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.weight = empty_param(dim)
        self.bias = empty_param(dim)
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class Conv1D(nn.Module):
    """HF GPT-2's projection: ``weight`` stored ``[in, out]``."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.weight = empty_param(n_in, n_out)
        self.bias = empty_param(n_out)

    def forward(self, x: Tensor) -> Tensor:
        return linear(x, self.weight, self.bias)


class Linear(nn.Module):
    """``torch.nn.Linear``'s layout: ``weight`` stored ``[out, in]``."""

    def __init__(self, n_in: int, n_out: int, bias: bool = True):
        super().__init__()
        self.weight = empty_param(n_out, n_in)
        self.bias = empty_param(n_out) if bias else None

    def forward(self, x: Tensor) -> Tensor:
        return linear(x, in_out(self.weight), self.bias)


class Conv(nn.Module):
    """A ``Conv2d``'s weights: ``weight`` [out, in, kh, kw] and ``bias``."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int, bias: bool = True):
        super().__init__()
        self.weight = empty_param(cout, cin, kh, kw)
        self.bias = empty_param(cout) if bias else None


class BatchNorm(nn.Module):
    """An inference-mode ``BatchNorm2d``'s four tensors under its keys
    (``weight``, ``bias``, ``running_mean``, ``running_var``)."""

    def __init__(self, n: int, eps: float = 1e-5):
        super().__init__()
        self.weight = empty_param(n)
        self.bias = empty_param(n)
        self.register_buffer("running_mean", torch.empty(n))
        self.register_buffer("running_var", torch.empty(n))
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        """Channel-last ``x``: ``(x - mean) · rsqrt(var + eps) · weight + bias``."""
        return ((x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
                * self.weight + self.bias)

    def folded(self):
        """``(scale, shift)`` in fp32, folded in fp64: ``x·scale + shift``
        is the batch norm (the JAX package's import-time fold)."""
        scale = self.weight.double() * torch.rsqrt(self.running_var.double() + self.eps)
        return scale.float(), (self.bias.double() - self.running_mean.double() * scale).float()


def in_out(weight) -> Tensor:
    """A ``[out, in]`` weight (``Linear`` layout) as ``linear`` takes it:
    transposed, or an :class:`Int8Weight` as it is (it knows its layout)."""
    return weight if isinstance(weight, Int8Weight) else weight.t()


# Initializers: numpy on the host, the same draws in the same order as the
# JAX package's, so a seed gives both packages identical weights.


def normal_init(rng: np.random.Generator, shape, std: float = 0.02) -> np.ndarray:
    return rng.normal(0.0, std, size=shape).astype(np.float32)


def zeros_init(shape) -> np.ndarray:
    return np.zeros(shape, dtype=np.float32)


def ones_init(shape) -> np.ndarray:
    return np.ones(shape, dtype=np.float32)


def torch_linear_init(rng: np.random.Generator, in_dim: int, out_dim: int):
    """``torch.nn.Linear``'s default init drawn with numpy → ``(w[in, out],
    b[out])``, as the JAX package draws it."""
    bound = 1.0 / math.sqrt(in_dim)
    w = rng.uniform(-math.sqrt(1.0 / in_dim) * math.sqrt(3.0),
                    math.sqrt(1.0 / in_dim) * math.sqrt(3.0),
                    size=(in_dim, out_dim))
    b = rng.uniform(-bound, bound, size=(out_dim,))
    return w.astype(np.float32), b.astype(np.float32)
