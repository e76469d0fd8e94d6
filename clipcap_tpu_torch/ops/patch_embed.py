"""Patch embedding straight off uint8 images: im2col and the patch product
in one kernel.

Counterpart of ``clipcap_tpu/ops/patch_embed.py``.  :func:`patch_embed`
takes the raw ``[B, H, W, 3]`` uint8 batch and the folded ``[3P², D]``
bf16 patch weight (pixel normalisation and the /255 already in it, rows in
the shipping ``(c, ph, pw)`` order) and returns ``[B, (H/P)(W/P), D]``
bf16.  On CUDA it is one launch of ``csrc/patch_embed.cu`` (no fallback);
:func:`patch_embed_ref` is its plain twin, which a CPU tensor reaches.
Both widen the pixels exactly to bf16, accumulate the product in fp32, add
the bias in fp32 and round once.
"""
from __future__ import annotations

from typing import Optional

import torch

from clipcap_tpu_torch.ops import _build

Tensor = torch.Tensor


def patchify(images: Tensor, patch: int) -> Tensor:
    """[B, H, W, 3] → [B, (H/p)(W/p), 3·p·p], patch rows ordered (c, ph, pw)
    as the flattened Conv2d weight."""
    B, H, W, C = images.shape
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(B, gh * gw, C * patch * patch)


def patch_embed_supported(images: Tensor, patch: int) -> bool:
    """uint8 NHWC inputs whose geometry divides evenly (every CLIP preset)."""
    if images.ndim != 4 or images.dtype != torch.uint8:
        return False
    B, H, W, C = images.shape
    return C == 3 and H % patch == 0 and W % patch == 0 and B >= 1


# The kernel's pixel paths (bit flags of the C entry's ``path``): how a
# tile's pixels reach shared memory.  RUNS stages the image rows that one
# 32-row block of a patch's pixels covers (P = 16, 32), else the tile's
# whole patch rows as one span; BYTES fills the stages with the producer's
# own loads where the copy engine cannot address the batch (a start off 16
# bytes, or rows whose length is not a multiple of 16).
BYTES, RUNS = 1, 2


def pixel_path(shape, patch: int, data_ptr: int) -> int:
    """The pixel path of a ``[B, H, W, 3]`` uint8 batch at ``data_ptr``: the
    copy engine's 1-D bulk copies need 16-byte aligned starts and lengths,
    so runs need a 16-byte multiple image row (3W) and the span a 16-byte
    multiple patch row (3WP)."""
    W = shape[2]
    runs = patch in (16, 32)
    step = 3 * W if runs else 3 * W * patch
    return (RUNS if runs else 0) | (0 if data_ptr % 16 == 0 and step % 16 == 0 else BYTES)


def patch_embed_ref(images: Tensor, w: Tensor, bias: Optional[Tensor], patch: int) -> Tensor:
    """Plain twin of the kernel: bf16 pixels, fp32 product, fp32 bias, one
    rounding to bf16."""
    x = patchify(images.to(torch.bfloat16).float(), patch)
    y = x @ w.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(torch.bfloat16)


def _check(images: Tensor, w: Tensor, bias: Optional[Tensor], patch: int) -> None:
    if not patch_embed_supported(images, patch):
        raise ValueError(f"patch_embed: needs uint8 [B, H, W, 3] images with H and W "
                         f"divisible by {patch}, got {images.dtype} {tuple(images.shape)}")
    if w.ndim != 2 or w.shape[0] != 3 * patch * patch or w.dtype != torch.bfloat16:
        raise ValueError(f"patch_embed: needs a bf16 [{3 * patch * patch}, D] weight, got "
                         f"{w.dtype} {tuple(w.shape)}")
    D = w.shape[1]
    if D % 8:
        raise ValueError(f"patch_embed: the width {D} must be a multiple of 8")
    if bias is not None and (bias.shape != (D,) or bias.dtype != torch.bfloat16):
        raise ValueError(f"patch_embed: needs a bf16 [{D}] bias, got {bias.dtype} "
                         f"{tuple(bias.shape)}")
    for t in (w, bias):
        if t is not None and t.device != images.device:
            raise ValueError(f"patch_embed: tensors on {t.device} and {images.device}")
    if not all(t.is_contiguous() for t in (images, w, bias) if t is not None):
        raise ValueError("patch_embed: images, weight and bias must be contiguous")
    if any(t.data_ptr() % 16 for t in (w, bias) if t is not None):
        raise ValueError("patch_embed: weight and bias must be 16-byte aligned")
    if images.numel() >= 2 ** 31:
        raise ValueError("patch_embed: the kernel takes batches under 2^31 bytes")


def patch_embed(images: Tensor, w: Tensor, bias: Optional[Tensor], patch: int) -> Tensor:
    """One-pass uint8 im2col + patch product → ``[B, N, D]`` bf16.

    A CPU tensor goes to the twin; a CUDA tensor launches
    ``csrc/patch_embed.cu`` or raises (the kernel refuses a launch whose
    tile of pixels exceeds its shared memory)."""
    if images.device.type == "cpu":
        return patch_embed_ref(images, w, bias, patch)
    if images.device.type != "cuda":
        raise ValueError(f"patch_embed: unsupported device {images.device}")
    _check(images, w, bias, patch)
    B, H, W, _ = images.shape
    D = w.shape[1]
    lib = _build.load_library()
    out = torch.empty((B, (H // patch) * (W // patch), D), dtype=torch.bfloat16,
                      device=images.device)
    with torch.cuda.device(images.device):   # the launch goes to the current device
        code = lib.clipcap_patch_embed(
            images.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), B, H, W, patch, D,
            pixel_path(images.shape, patch, images.data_ptr()), _build.stream_of(images))
    _build.check(code, "patch_embed")
    patch_embed.launches += 1
    return out


patch_embed.launches = 0
