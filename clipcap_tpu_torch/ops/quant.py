"""Int8 weights for serving: weight-only (w8a16) for GPT-2, w8a8 for CLIP.

Counterpart of ``clipcap_tpu/ops/quant.py``.  A projection weight becomes
an :class:`~clipcap_tpu_torch.ops.layers.Int8Weight`: int8 ``q`` with fp32
per-output-channel absmax scales ``s``, the JAX package's ``{"q", "s"}``
form, bit for bit.  ``ops.layers.linear`` takes it as a weight-only int8
product; :func:`int8_linear` quantises the activations per row as well and
contracts int8 × int8 → int32 (``torch._int_mm``).  Neither is a Pallas
kernel in the JAX package (both are XLA dots), so the port runs them as
PyTorch calls.

:func:`quantize_gpt2_int8` and :func:`quantize_clip_visual_int8` return a
copy of the module with each block projection weight replaced; layer
norms, embeddings, the patch embedding and the final projection stay in
float, and everything else is copied as it is.  Quantise from the fp32
weights, as the JAX CLIs do: a bf16 copy has other absmaxes and quotients.
"""
from __future__ import annotations

import copy
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clipcap_tpu_torch.ops.layers import Int8Weight

Tensor = torch.Tensor

# torch._int_mm on CUDA takes only more than 16 rows.
INT_MM_MIN_ROWS = 17


def _scale(absmax: Tensor) -> Tensor:
    """``max(absmax, 1e-8) / 127`` as a true division on every device: CUDA
    divides by a Python scalar as a product with its reciprocal, which can
    be one ulp off, and a scale one ulp off moves quotients across .5."""
    return absmax.clamp_min(1e-8) / torch.full_like(absmax, 127.0)


def quantize_linear(w: Tensor, out_in: bool = False) -> Int8Weight:
    """Per-output-channel symmetric int8 of an fp32 weight: ``w ≈ q · s``
    with ``s = max(absmax, 1e-8) / 127`` over the input dim, ``q`` rounded
    half to even and clipped to ±127.  ``w`` is ``[in, out]``, or
    ``[out, in]`` with ``out_in``; ``q`` keeps that layout."""
    if w.dtype != torch.float32:
        raise ValueError(f"quantize from the fp32 weights, not {w.dtype}: the absmax and "
                         "the quotients of a rounded copy differ")
    w = w.detach()
    s = _scale(w.abs().amax(dim=-1 if out_in else -2, keepdim=True))
    q = torch.round(w / s).clamp(-127, 127).to(torch.int8)
    return Int8Weight(q, s.flatten(), out_in)


def quantize_rows(x: Tensor) -> Tuple[Tensor, Tensor]:
    """Dynamic per-row symmetric int8 over the trailing dim, in fp32:
    ``x ≈ q · s`` with ``s = max(absmax, 1e-8) / 127`` [..., 1] — the
    activation side of a w8a8 product."""
    x = x.float()
    s = _scale(x.abs().amax(dim=-1, keepdim=True))
    q = torch.round(x / s).clamp(-127, 127).to(torch.int8)
    return q, s


def int8_linear(x: Tensor, w: Int8Weight, b=None) -> Tensor:
    """w8a8 linear: per-row int8 ``x`` × per-channel int8 ``w``, contracted
    int8 × int8 → int32 by ``torch._int_mm``, rescaled in fp32 by
    ``s_row · s_col``, plus the bias, cast to ``x.dtype``.

    ``_int_mm`` on CUDA refuses 16 rows or fewer (the class-token block of
    a small batch): such calls run on zero rows padded to 17, which
    quantise to zero and are cut from the product.  It also wants K and N
    multiples of 8, as every CLIP width is.  ``w.in_out()`` of a
    ``Linear``-layout weight is column-major, the operand layout it takes
    without a copy."""
    if not isinstance(w, Int8Weight):
        raise TypeError("int8_linear takes an Int8Weight (ops.quant.quantize_linear)")
    q, s = quantize_rows(x)
    lead, k = q.shape[:-1], q.shape[-1]
    a = q.reshape(-1, k)
    m = a.shape[0]
    if m < INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, INT_MM_MIN_ROWS - m))
    acc = torch._int_mm(a, w.in_out())[:m].reshape(*lead, -1)
    y = acc.float() * s * w.s.float()
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


def _quantized_copy(module: nn.Module, weights: List[Tuple[str, str, bool]]) -> nn.Module:
    """A deep copy of ``module`` with each ``(submodule, attribute, out_in)``
    weight replaced by its :func:`quantize_linear` form.  The float weights
    being replaced are not copied; everything else is, so the copy shares
    no tensor with ``module``."""
    owners = [(module.get_submodule(path), name, out_in) for path, name, out_in in weights]
    memo = {id(getattr(owner, name)): None for owner, name, _ in owners}
    out = copy.deepcopy(module, memo)
    for (path, name, _), (owner, _, out_in) in zip(weights, owners):
        target = out.get_submodule(path)
        delattr(target, name)                 # the parameter slot the memo left empty
        setattr(target, name, quantize_linear(getattr(owner, name), out_in=out_in))
    return out


def quantize_gpt2_int8(lm: nn.Module) -> nn.Module:
    """A copy of a :class:`~clipcap_tpu_torch.models.gpt2.GPT2` with the
    block projections (attn ``c_attn``/``c_proj``, mlp ``c_fc``/``c_proj``,
    ``Conv1D`` layout ``[in, out]``) in int8; ``wte``/``wpe``, layer norms
    and biases stay float.  Served through ``linear`` as weight-only int8."""
    weights = [(f"h.{i}.{sub}", "weight", False) for i in range(len(lm.h))
               for sub in ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")]
    return _quantized_copy(lm, weights)


def quantize_clip_visual_int8(module: nn.Module) -> nn.Module:
    """A copy of a CLIP ``VisionTransformer`` (or of a whole ``CLIP``, whose
    text tower is copied as it is) with the image blocks' projections
    (``attn.in_proj_weight``, ``attn.out_proj``, ``mlp.c_fc``,
    ``mlp.c_proj``, ``Linear`` layout ``[out, in]``) in int8.  The patch
    embedding, class and positional embeddings, layer norms and the final
    projection stay float: the pixel normalisation folded into the patch
    weights must stay exact."""
    visual, prefix = (module.visual, "visual.") if hasattr(module, "visual") else (module, "")
    weights = []
    for i in range(len(visual.transformer.resblocks)):
        block = f"{prefix}transformer.resblocks.{i}"
        weights += [(f"{block}.attn", "in_proj_weight", True),
                    *((f"{block}.{sub}", "weight", True)
                      for sub in ("attn.out_proj", "mlp.c_fc", "mlp.c_proj"))]
    return _quantized_copy(module, weights)
