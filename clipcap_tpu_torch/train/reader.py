"""The streaming embedding reader (``embeddings/*.npy`` + ``captions/*.parquet``).

This is the JAX package's ``clipcap_tpu/train/reader.py``, which imports
only numpy and pandas, loaded from its file.  Importing it as
``clipcap_tpu.train.reader`` would run ``clipcap_tpu/train/__init__.py``,
which imports JAX.
"""
from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

_NAME = "clipcap_tpu_torch.train._jax_free_reader"


def _load():
    if _NAME not in sys.modules:
        package = importlib.util.find_spec("clipcap_tpu")      # does not import it
        source = Path(package.submodule_search_locations[0]) / "train" / "reader.py"
        spec = importlib.util.spec_from_file_location(_NAME, source)
        module = importlib.util.module_from_spec(spec)
        sys.modules[_NAME] = module            # dataclasses look their module up
        spec.loader.exec_module(module)
    return sys.modules[_NAME]


EmbeddingReader = _load().EmbeddingReader

__all__ = ["EmbeddingReader"]
