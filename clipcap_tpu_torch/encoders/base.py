"""Encoder registry: name → ``(encoder, transform)``.

Counterpart of ``clipcap_tpu/encoders/base.py``.  The encoder is callable
on a batch of transformed samples and returns numpy embeddings; the
transform maps a file path / BytesIO to one sample array.  Only CLIP ViT
encoders are ported (``int8``: the w8a8 image tower); CLAP raises.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

from clipcap_tpu_torch.config import EncoderConfig


def get_encoder(encoder_model_name: str, encoder_model_variant: str,
                normalize_embeddings: bool = False, window_size: Optional[int] = None,
                use_windowed_embeddings: bool = False, window_overlap_percentage: float = 0.0,
                device="cuda", checkpoint_path: Optional[str] = None,
                int8: bool = False) -> Tuple[Callable, Callable]:
    if encoder_model_name == "clip":
        from clipcap_tpu_torch.encoders.clip import get_clip_encoder

        return get_clip_encoder(encoder_model_variant,
                                use_windowed_embeddings=use_windowed_embeddings,
                                window_size=window_size,
                                window_overlap_percentage=window_overlap_percentage,
                                normalize_embeddings=normalize_embeddings,
                                checkpoint_path=checkpoint_path, device=device, int8=int8)
    if encoder_model_name == "clap":
        raise NotImplementedError("the CLAP encoder is not ported yet (ROADMAP.md, queue A)")
    raise ValueError(f"invalid encoder name: '{encoder_model_name}'")


def get_encoder_from_config(config: EncoderConfig, device="cuda",
                            checkpoint_path: Optional[str] = None, int8: bool = False):
    variant = config.encoder_model_variant
    if config.encoder_model_name == "clip":
        variant = variant.replace("_", "/")   # CLI variant un-mangling
    return get_encoder(config.encoder_model_name, variant,
                       normalize_embeddings=config.normalize_embeddings,
                       use_windowed_embeddings=config.use_windowed_embeddings,
                       window_size=config.window_size,
                       window_overlap_percentage=config.window_overlap_percentage,
                       device=device, checkpoint_path=checkpoint_path, int8=int8)


def get_encoder_from_model(model, device=None):
    """The encoder a ClipCapModel was trained against, on ``device``
    (default: the model's)."""
    return get_encoder_from_config(model.config.encoder_config,
                                   device=model.device if device is None else device)
