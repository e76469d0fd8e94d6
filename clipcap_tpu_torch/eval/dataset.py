"""Eval dataset: glob a folder, yield (filename, transformed sample)
(reference ClipCap's clipcap/eval/dataset.py:4-22)."""
from __future__ import annotations

from pathlib import Path
from typing import Callable


class EvalDataset:
    def __init__(self, sample_processor: Callable, folder: str):
        folder = Path(folder).resolve()
        self.media_files = sorted(p for p in folder.glob("*") if p.is_file())
        self.sample_processor = sample_processor

    def __len__(self) -> int:
        return len(self.media_files)

    def __iter__(self):
        for media_file in self.media_files:
            yield media_file.name, self.sample_processor(str(media_file))
