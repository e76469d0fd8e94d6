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

Tensor = torch.Tensor


def round_up(n: int, m: int) -> int:
    """Smallest multiple of ``m`` >= ``n``."""
    return (n + m - 1) // m * m


def gelu_new(x: Tensor) -> Tensor:
    """GPT-2's tanh-approximated GELU (HF ``gelu_new``)."""
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x * x * x)))


def quick_gelu(x: Tensor) -> Tensor:
    """OpenAI CLIP's QuickGELU: ``x * sigmoid(1.702 * x)``."""
    return x * torch.sigmoid(1.702 * x)


def relu(x: Tensor) -> Tensor:
    return torch.clamp_min(x, 0)


ACTIVATIONS = {
    "gelu_new": gelu_new,
    "quick_gelu": quick_gelu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu's default
    "relu": relu,
}


def layer_norm(x: Tensor, scale: Tensor, bias: Tensor, eps: float = 1e-5) -> Tensor:
    """LayerNorm over the trailing dim, computed in float32."""
    orig = x.dtype
    x = x.float()
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(orig)


def linear(x: Tensor, w: Tensor, b: Optional[Tensor] = None) -> Tensor:
    """``x @ w (+ b)`` with ``w`` stored ``[in, out]`` (HF ``Conv1D``
    layout) and cast to the dtype of ``x``."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def embed(table: Tensor, ids: Tensor, dtype: torch.dtype) -> Tensor:
    """Embedding lookup, cast to the compute dtype."""
    return F.embedding(ids.long(), table).to(dtype)


# Parameter holders.  Weights arrive from a parameter tree
# (``clipcap_tpu_torch.convert``), so they start empty, and they are frozen:
# the port serves and does not train.


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
        return linear(x, self.weight.t(), self.bias)


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
