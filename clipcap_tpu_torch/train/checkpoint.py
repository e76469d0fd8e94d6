"""``.npz`` parameter checkpoints, interchangeable with the JAX package's.

Counterpart of the npz half of ``clipcap_tpu/train/checkpoint.py``: a
parameter tree (nested dicts of arrays, the JAX layout —
``clipcap_tpu_torch.convert``) is stored flat, one array per leaf, under
its path joined by ``SEP``.  A file the JAX package's ``save_params``
writes loads here and the other way round.  Orbax directories are not
ported.
"""
from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

SEP = "::"  # flat-key separator, as in the JAX package


def _flatten(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}{SEP}{key}" if prefix else str(key)
        if isinstance(value, dict):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _require_npz(path: str) -> None:
    if not path.endswith(".npz"):
        raise NotImplementedError(f"{path}: only .npz checkpoints are ported "
                                  "(orbax directories are not; ROADMAP.md, queue A)")


def save_params(path: str, params: dict) -> None:
    """Save a parameter tree to a single ``.npz`` file."""
    _require_npz(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **_flatten(params))


def restore_params(path: str, like: Optional[dict] = None) -> dict:
    """Load a parameter tree.  Keys under ``params::`` (a full train-state
    checkpoint) are read as the parameters.  With ``like``, every leaf of
    ``like`` must be present with the same shape, and only those are read."""
    _require_npz(path)
    with np.load(path) as flat:
        items = {k: flat[k] for k in flat.files}
    if any(k.startswith(f"params{SEP}") for k in items):
        items = {k[len(f"params{SEP}"):]: v for k, v in items.items()
                 if k.startswith(f"params{SEP}")}
    if like is not None:
        want = _flatten(like)
        for key, leaf in want.items():
            if key not in items:
                raise KeyError(f"checkpoint {path} missing key '{key}'")
            if items[key].shape != leaf.shape:
                raise ValueError(f"shape mismatch for '{key}': ckpt {items[key].shape} "
                                 f"vs model {leaf.shape}")
        items = {k: items[k] for k in want}
    tree: dict = {}
    for key, value in items.items():
        *parents, leaf = key.split(SEP)
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree
