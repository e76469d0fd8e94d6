"""CLAP audio encoder: host-side audio transform + batched forward on the device.

Counterpart of ``clipcap_tpu/encoders/clap.py``.  The host decodes,
mixes to mono (the channel mean) and resamples to 48 kHz with the numpy
sinc resampler, then crops or pads to a fixed 10 s so batches have one
shape; the device runs the log-mel frontend, HTSAT and the projection
(``clipcap_tpu_torch.models.htsat``).
"""
from __future__ import annotations

import io
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from clipcap_tpu_torch.models.htsat import (CLAP_PRESETS, CLAPAudio, CLAPText, HTSATConfig,
                                            clap_audio_embedding, clap_audio_embedding_fusion,
                                            clap_text_embedding, load_clap)
from clipcap_tpu_torch.ops.audio import (CLAP_CLIP_SAMPLES, CLAP_SAMPLE_RATE,
                                         build_mel_fusion, load_audio, resample, to_mono)
from clipcap_tpu_torch.utils.device import resolve_device


class CLAPTransform:
    """file / BytesIO / bytes → fixed-shape model input at 48 kHz.

    Plain mode: the float32 waveform ``[CLAP_CLIP_SAMPLES]`` (10 s crop or
    zero-pad).  Fusion mode (``enable_fusion``, fusion checkpoints): the
    laion_clap fusion input ``[4, frames, 64]`` built on the host
    (``ops.audio.build_mel_fusion``) after the int16 round trip, so >10 s
    audio contributes its whole duration.
    """

    def __init__(self, sample_rate: int = CLAP_SAMPLE_RATE,
                 clip_samples: int = CLAP_CLIP_SAMPLES,
                 enable_fusion: bool = False) -> None:
        self.sample_rate = sample_rate
        self.clip_samples = clip_samples
        self.enable_fusion = enable_fusion

    def __call__(self, file: Union[io.BytesIO, str, bytes]) -> np.ndarray:
        waveform, file_rate = load_audio(file)
        waveform = to_mono(waveform)
        if file_rate != self.sample_rate:
            waveform = resample(waveform, file_rate, self.sample_rate)
        if self.enable_fusion:
            w = np.trunc(np.clip(waveform, -1.0, 1.0) * 32767.0) / 32767.0
            return build_mel_fusion(w.astype(np.float32))
        out = np.zeros((self.clip_samples,), dtype=np.float32)
        n = min(len(waveform), self.clip_samples)
        out[:n] = waveform[:n]
        return out


class CLAPEncoder:
    """Batched audio-embedding forward: ``[B, samples]`` waveforms (or
    ``[B, 4, frames, 64]`` fusion inputs) → numpy fp32 ``[B, E]``."""

    def __init__(self, audio: CLAPAudio, config: HTSATConfig,
                 normalize_embeddings: bool = False, dtype=torch.float32,
                 text: Optional[Tuple[CLAPText, object]] = None):
        self.audio = audio
        self.config = config
        self.normalize_embeddings = normalize_embeddings
        self.embedding_size = config.embedding_dim
        self.dtype = dtype
        self.text = text  # (CLAPText, RobertaConfig): the rerank tower

    @property
    def device(self) -> torch.device:
        return self.audio.audio_projection["0"].weight.device

    def _forward(self, batch: torch.Tensor) -> torch.Tensor:
        if batch.ndim == 4:
            out = clap_audio_embedding_fusion(self.audio, batch, dtype=self.dtype)
        else:
            out = clap_audio_embedding(self.audio, batch, dtype=self.dtype)
        if self.normalize_embeddings:
            out = out / out.norm(dim=-1, keepdim=True)
        return out.float()

    @torch.no_grad()
    def __call__(self, batch) -> np.ndarray:
        return self._forward(torch.tensor(np.asarray(batch), device=self.device)).cpu().numpy()

    @torch.no_grad()
    def encode_text(self, captions) -> np.ndarray:
        """Captions → L2-normalised joint-space embeddings [N, E]
        (laion_clap ``get_text_embedding``: RoBERTa pooler → projection)."""
        from clipcap_tpu_torch.utils.roberta_tokenizer import roberta_tokenize

        text, roberta_cfg = self.text
        ids, mask = roberta_tokenize(captions, vocab_size=roberta_cfg.vocab_size)
        emb = clap_text_embedding(text, torch.from_numpy(ids).to(self.device),
                                  torch.from_numpy(mask).to(self.device), dtype=self.dtype)
        return (emb / emb.norm(dim=-1, keepdim=True)).float().cpu().numpy()

    @torch.no_grad()
    def similarity(self, sample, captions) -> np.ndarray:
        """Audio↔caption rerank signal: cosine similarity in the CLAP joint
        space, [n_captions]."""
        audio = self._forward(torch.tensor(np.asarray(sample), device=self.device)[None])
        audio = (audio / audio.norm(dim=-1, keepdim=True)).cpu().numpy()
        return (audio @ self.encode_text(list(captions)).T)[0]


def get_clap_encoder(encoder_model_variant: str = "HTSAT-tiny",
                     normalize_embeddings: bool = False,
                     checkpoint_path: Optional[str] = None, device="cuda",
                     dtype=torch.float32, **_ignored) -> Tuple[Callable, Callable]:
    """``(encoder, transform)`` for a CLAP variant on ``device`` (a CUDA
    device raises when CUDA is absent).  The CLI's variant flag defaults to
    a CLIP name; an unknown variant maps to ``HTSAT-tiny``."""
    if encoder_model_variant not in CLAP_PRESETS:
        encoder_model_variant = "HTSAT-tiny"
    audio, config, text = load_clap(encoder_model_variant, checkpoint_path,
                                    device=resolve_device(device))
    transform = CLAPTransform(enable_fusion=config.enable_fusion)
    encoder = CLAPEncoder(audio, config, normalize_embeddings=normalize_embeddings,
                          dtype=dtype, text=text)
    return encoder, transform
