"""CLIP image encoder: host-side PIL transform + batched forward on the device.

Counterpart of ``clipcap_tpu/encoders/clip.py``.  The host decodes and
resizes/crops to fixed-shape uint8 HWC arrays at the variant's own size
(224 to 448); the device does the rest (uint8 → float, normalisation, the
ViT or the ModifiedResNet).
"""
from __future__ import annotations

import math
from io import BytesIO
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from clipcap_tpu_torch.models.clip_vit import (CLIP, CLIPConfig, clip_encode_image,
                                               clip_encode_text, clip_similarity,
                                               is_resnet_config, load_clip)
from clipcap_tpu_torch.utils.device import resolve_device
from clipcap_tpu_torch.utils.profiling import annotate


def _resize(image, size: Tuple[int, int]):
    from PIL import Image

    return image.resize(size, resample=Image.BICUBIC)


class CLIPTransform:
    """file / BytesIO / bytes → uint8 array [n_px, n_px, 3] (plain) or
    [window_size + 1, n_px, n_px, 3] (windowed: global view + tiles)."""

    def __init__(self, n_px: int, use_windowed_embeddings: bool = False,
                 window_size: Optional[int] = 3 * 3,
                 window_overlap_percentage: float = 0.0) -> None:
        if use_windowed_embeddings and not math.sqrt(window_size).is_integer():
            raise ValueError("`window_size` must be a square number with CLIP, e.g. (3x3) = 9.")
        self.n_px = n_px
        self.use_windowed_embeddings = use_windowed_embeddings
        self.window_size = window_size
        self.window_overlap_percentage = window_overlap_percentage

    def center_crop(self, image):
        width, height = image.size
        if width > height:
            left = (width - height) // 2
            image = image.crop((left, 0, left + height, height))
        elif height > width:
            top = (height - width) // 2
            image = image.crop((0, top, width, top + width))
        return image

    def ensure_tileable(self, image):
        size, _ = image.size
        tiles_per_axis = int(math.sqrt(self.window_size))
        target = math.ceil(size / tiles_per_axis) * tiles_per_axis
        if target != size:
            from PIL import Image

            image = image.resize((target, target), resample=Image.BILINEAR)
        return image

    def tile_image(self, image) -> np.ndarray:
        size, _ = image.size
        tiles_per_axis = int(math.sqrt(self.window_size))
        pixels_per_tile = size // tiles_per_axis
        step = pixels_per_tile
        if self.window_overlap_percentage != 0:
            step = math.floor(pixels_per_tile * (1 - self.window_overlap_percentage / 100))
        arr = np.asarray(image.convert("RGB"))
        return np.stack([arr[ty * step:ty * step + pixels_per_tile,
                             tx * step:tx * step + pixels_per_tile]
                         for ty in range(tiles_per_axis) for tx in range(tiles_per_axis)])

    def _clip_preprocess(self, image) -> np.ndarray:
        """Resize the shorter side to n_px (bicubic), centre-crop, RGB uint8."""
        w, h = image.size
        scale = self.n_px / min(w, h)
        image = _resize(image, (max(self.n_px, int(round(w * scale))),
                                max(self.n_px, int(round(h * scale)))))
        w, h = image.size
        left, top = (w - self.n_px) // 2, (h - self.n_px) // 2
        image = image.crop((left, top, left + self.n_px, top + self.n_px))
        return np.asarray(image.convert("RGB"), dtype=np.uint8)

    def __call__(self, file: Union[BytesIO, str, bytes]) -> np.ndarray:
        from PIL import Image

        if isinstance(file, bytes):
            file = BytesIO(file)
        image = Image.open(file)
        if self.use_windowed_embeddings:
            tiles = self.tile_image(self.ensure_tileable(self.center_crop(image)))
            tile_imgs = np.stack([np.asarray(_resize(Image.fromarray(t), (self.n_px, self.n_px)))
                                  for t in tiles])
            return np.concatenate([self._clip_preprocess(image)[None], tile_imgs], axis=0)
        return self._clip_preprocess(image)


class CLIPEncoder:
    """Batched embedding forward: ``[B, n_px, n_px, 3]`` uint8 (or
    ``[B, W+1, n_px, n_px, 3]`` windowed) → numpy fp32 ``[B, E]`` (or
    ``[B, W+1, E]``)."""

    def __init__(self, model: CLIP, config: CLIPConfig, normalize_embeddings: bool = False,
                 use_windowed_embeddings: bool = False, dtype=torch.bfloat16,
                 int8: bool = False):
        if int8:
            # w8a8 serving: the image blocks' projection weights quantised
            # once here, the activations per row at each projection.
            from clipcap_tpu_torch.ops.quant import quantize_clip_visual_int8

            if is_resnet_config(config.vision):
                raise ValueError("int8 serving is CLIP-ViT-only (RN towers are conv-bound; the "
                                 "w8a8 projection path does not apply)")

            model = quantize_clip_visual_int8(model)
        self.model = model
        self.config = config
        self.normalize_embeddings = normalize_embeddings
        self.use_windowed_embeddings = use_windowed_embeddings
        self.embedding_size = config.vision.embed_dim
        self.dtype = dtype
        self.int8 = int8

    @property
    def device(self) -> torch.device:
        return self.model.logit_scale.device

    @torch.no_grad()
    def __call__(self, batch) -> np.ndarray:
        with annotate("encoder.h2d"):
            x = torch.tensor(np.asarray(batch), device=self.device)
        lead = x.shape[:-3]
        with annotate("encoder.tower"):
            out = clip_encode_image(self.model.visual, x.reshape((-1,) + x.shape[-3:]),
                                    dtype=self.dtype, int8_acts=self.int8)
            if self.normalize_embeddings:
                out = out / out.norm(dim=-1, keepdim=True)
            out = out.float().reshape(*lead, -1)
        with annotate("encoder.d2h"):
            return out.cpu().numpy()

    def _tokens(self, captions) -> torch.Tensor:
        from clipcap_tpu_torch.utils.clip_tokenizer import tokenize

        return torch.as_tensor(tokenize(list(captions)), device=self.device)

    @torch.no_grad()
    def encode_text(self, captions) -> np.ndarray:
        """Captions → L2-normalised joint-space embeddings [n, E] (fp32)."""
        emb = clip_encode_text(self.model, self._tokens(captions), dtype=torch.float32)
        return (emb / emb.norm(dim=-1, keepdim=True)).cpu().numpy()

    @torch.no_grad()
    def similarity(self, sample, captions) -> np.ndarray:
        """Image↔caption similarity logits [n_captions] for the rerank;
        ``sample`` is one transformed image (the global view if windowed).
        An int8 encoder reranks through the same w8a8 image path it embeds
        with."""
        img = torch.tensor(np.asarray(sample), device=self.device)
        if img.ndim == 4:
            img = img[0]
        logits_per_image, _ = clip_similarity(self.model, img[None], self._tokens(captions),
                                              dtype=torch.float32, int8_acts=self.int8)
        return logits_per_image[0].cpu().numpy()


def get_clip_encoder(encoder_model_variant: str, window_size: Optional[int] = None,
                     normalize_embeddings: bool = False, use_windowed_embeddings: bool = False,
                     window_overlap_percentage: float = 0.0,
                     checkpoint_path: Optional[str] = None, device="cuda",
                     dtype=torch.bfloat16, int8: bool = False) -> Tuple[Callable, Callable]:
    """``(encoder, transform)`` for a CLIP variant (ViT or RN) on ``device``
    (a CUDA device raises when CUDA is absent); ``int8``: the w8a8 ViT
    image tower."""
    model, config = load_clip(encoder_model_variant, checkpoint_path,
                              device=resolve_device(device))
    transform = CLIPTransform(n_px=config.vision.image_size,
                              use_windowed_embeddings=use_windowed_embeddings,
                              window_size=window_size,
                              window_overlap_percentage=window_overlap_percentage)
    encoder = CLIPEncoder(model, config, normalize_embeddings=normalize_embeddings,
                          use_windowed_embeddings=use_windowed_embeddings, dtype=dtype,
                          int8=int8)
    return encoder, transform
