"""Partition writer for the preprocess stage.

The port's own copy of ``clipcap_tpu/preprocess/writer.py``.  Only the
on-disk *artifact contract* is shared with the reference, so that datasets
written by either side load in the other:

    <out>/encoder_config.yaml                      run-describing YAML
    <out>/embeddings/embeds_<NNN>.npy              float matrix, row/sample
    <out>/captions/captions_<NNN>.parquet          single column ``caption``

``<NNN>`` is the partition id zero-padded to the digit width of the total
partition count, which both sides compute identically.  The implementation
is original: one ``PartitionWriter`` owns the accumulate→flush lifecycle
(the reference splits it across a sink object and a callable facade), and
paths are resolved once at construction.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import fsspec
import numpy as np
import yaml


def write_encoder_config(config, output_folder: str) -> None:
    """Persist the encoder config as ``encoder_config.yaml`` at the dataset
    root — the file the train stage reads to rebuild the encoder."""
    fs, root = fsspec.core.url_to_fs(output_folder)
    fs.makedirs(root, exist_ok=True)
    with fs.open(f"{root}/encoder_config.yaml", "w") as f:
        yaml.dump(config.to_dict(), f, default_flow_style=False)


def partition_tag(partition_id: int, output_partition_count: int) -> str:
    """Zero-padded partition label, padded to the digit width of the total
    count (``embeds_007.npy`` for 100+ partitions, ``embeds_0.npy`` for
    one) — must match the reference's padding for filename compatibility."""
    width = len(str(max(1, output_partition_count)))
    return f"{partition_id:0{width}d}"


class PartitionWriter:
    """Accumulates encoder output batches for one partition in host memory,
    then writes the whole partition as one npy/parquet pair on ``flush``.

    Batches are mappings with ``embeddings`` (array, one row per sample)
    and ``text`` (sequence of caption strings) — the shape the Runner's
    mapper stage emits.
    """

    def __init__(self, partition_id: int, output_folder: str,
                 output_partition_count: int):
        self._fs, root = fsspec.core.url_to_fs(output_folder)
        tag = partition_tag(partition_id, output_partition_count)
        self._embeds_path = f"{root}/embeddings/embeds_{tag}.npy"
        self._captions_path = f"{root}/captions/captions_{tag}.parquet"
        for path in (self._embeds_path, self._captions_path):
            self._fs.makedirs(path.rsplit("/", 1)[0], exist_ok=True)
        self._rows: list[np.ndarray] = []
        self._texts: list[str] = []

    def __call__(self, batch: Mapping[str, Sequence]) -> None:
        self._rows.append(np.asarray(batch["embeddings"]))
        self._texts.extend(batch["text"])

    @property
    def pending(self) -> int:
        """Samples accumulated since the last flush."""
        return sum(r.shape[0] for r in self._rows)

    def flush(self) -> None:
        """Write everything accumulated so far, then reset.  A writer that
        received no samples writes nothing (empty partitions leave no
        files, matching the reference)."""
        if not self._rows:
            return
        import pandas as pd

        with self._fs.open(self._embeds_path, "wb") as f:
            np.save(f, np.concatenate(self._rows))
        with self._fs.open(self._captions_path, "wb") as f:
            pd.DataFrame({"caption": self._texts}).to_parquet(f)
        self._rows, self._texts = [], []
