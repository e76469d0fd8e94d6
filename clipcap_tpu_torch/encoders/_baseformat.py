"""Template/contract for third-party encoders (the plugin interface of
``clipcap_tpu/encoders/_baseformat.py``).

Every encoder exposes two callables:

* ``transform(file) -> np.ndarray``, on the host: map a file path / BytesIO
  to ONE fixed-shape sample array (decode + resize/resample only; keep it
  cheap and thread-safe: it runs in the reader's worker pool).
* ``model(batch) -> np.ndarray``, on the device: map a stacked batch of
  samples to embeddings ``[B, embedding_size]`` (or ``[B, W, E]``
  windowed).  Move the batch to the model's device, run the forward under
  ``torch.no_grad()``, return fp32 numpy, and expose ``embedding_size``.

Register the encoder by adding a branch in
``clipcap_tpu_torch.encoders.base.get_encoder``.
"""
from __future__ import annotations

from io import BytesIO
from typing import Callable, Tuple, Union

import numpy as np


class BaseEncoderTransform:
    """Example transform: produce a fixed-shape array from a file."""

    def __init__(self, sample_shape=(8,)):
        self.sample_shape = sample_shape

    def __call__(self, file: Union[BytesIO, str]) -> np.ndarray:
        raise NotImplementedError("decode + preprocess your modality here")


class BaseEncoderModel:
    """Example model: batched forward returning embeddings."""

    embedding_size: int = 512

    def __call__(self, batch: np.ndarray) -> np.ndarray:
        raise NotImplementedError("run your encoder's PyTorch forward here")


def get_base_encoder(variant: str, normalize_embeddings: bool = False,
                     **kwargs) -> Tuple[Callable, Callable]:
    model = BaseEncoderModel()
    transform = BaseEncoderTransform()
    return model, transform
