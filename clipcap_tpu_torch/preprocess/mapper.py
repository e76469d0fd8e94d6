"""Mapper: batched encoder forward (counterpart of
``clipcap_tpu/preprocess/mapper.py``).  The encoder moves the batch to its
device, runs it, and returns numpy fp32 embeddings."""
from __future__ import annotations


class EncoderMapper:
    """Transforms media batches into embeddings."""

    def __init__(self, model):
        self.model = model

    def __call__(self, item: dict) -> dict:
        return {
            "embeddings": self.model(item["data_tensor"]),
            "text": item["text"],
        }
