"""``.npz`` checkpoints, interchangeable with the JAX package's.

Counterpart of the npz half of ``clipcap_tpu/train/checkpoint.py``: a
parameter tree (nested dicts of arrays, the JAX layout —
``clipcap_tpu_torch.convert``) is stored flat, one array per leaf, under
its path joined by ``SEP``.  A full train state is ``step``, ``params::…``
and ``opt_state::…`` under the key paths of the JAX package's optax state
(:func:`opt_state_layout`), moments in the JAX layout, scalars int32.  A
file either package writes loads in the other, and training resumes from
it.  Orbax directories are not ported.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

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
    items = _load_flat(path)
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
    return _unflatten(items)


def _load_flat(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as flat:
        return {k: flat[k] for k in flat.files}


def _unflatten(items: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, value in items.items():
        *parents, leaf = key.split(SEP)
        node = tree
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


# ---------------------------------------------------------------------------
# Full train-state checkpoints (resume-capable)
# ---------------------------------------------------------------------------


def opt_state_layout(tx) -> Tuple[str, List[str]]:
    """Where the JAX package's optax state for ``tx`` keeps Adam's moments
    (``<root>::mu::…``, ``<root>::nu::…``) and its counts.  Prefix-only
    training nests it under ``multi_transform``'s ``train`` branch, a clip
    under ``chain``'s second entry; ``optax.adamw`` is a chain of
    scale_by_adam (``#0``), the weight decay (``#1``, stateless) and the
    schedule (``#2``, a second count), the fused optimizer one state."""
    root = "opt_state"
    if not tx.train_language_model:
        root += f"{SEP}inner_states{SEP}train{SEP}inner_state"
    if tx.grad_clip_norm:
        root += f"{SEP}#1"
    if tx.fused:
        return root, [f"{root}{SEP}count"]
    return f"{root}{SEP}#0", [f"{root}{SEP}#0{SEP}count", f"{root}{SEP}#2{SEP}count"]


def _train_state_flat(state, tx) -> Dict[str, np.ndarray]:
    from clipcap_tpu_torch.convert import clipcap_tree

    adam, counts = opt_state_layout(tx)
    flat = {"step": np.asarray(state.step, np.int32)}
    flat.update(_flatten(state.model.params(), "params"))
    for key in counts:
        flat[key] = np.asarray(state.opt_state.count, np.int32)
    for name in ("mu", "nu"):
        moments = getattr(state.opt_state, name)
        flat.update(_flatten(clipcap_tree(state.model, moments), f"{adam}{SEP}{name}"))
    return flat


def save_train_state(path: str, state, tx) -> None:
    """Save a full train state (step, params, optimizer) as the JAX
    package's ``save_train_state`` lays it out for the same optimizer."""
    _require_npz(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    np.savez(path, **_train_state_flat(state, tx))


def restore_train_state(path: str, state, tx):
    """Load a train state written by either package for the same model and
    optimizer into ``state`` (in place: parameters, moments, counts) and
    return it."""
    from clipcap_tpu_torch.convert import clipcap_named

    _require_npz(path)
    flat = _load_flat(path)
    for key, like in _train_state_flat(state, tx).items():
        if key not in flat:
            raise KeyError(f"checkpoint {path} missing key '{key}'")
        if flat[key].shape != like.shape:
            raise ValueError(f"shape mismatch for '{key}': ckpt {flat[key].shape} vs "
                             f"state {like.shape}")
    adam, counts = opt_state_layout(tx)
    tree = _unflatten(flat)
    named = dict(state.model.named_parameters())
    with torch.no_grad():
        for k, v in clipcap_named(state.model, tree["params"]).items():
            named[k].copy_(v)
        moments = _unflatten({k[len(adam) + len(SEP):]: v for k, v in flat.items()
                              if k.startswith(adam + SEP)})
        for name in ("mu", "nu"):
            for k, v in clipcap_named(state.model, moments[name]).items():
                getattr(state.opt_state, name)[k].copy_(v)
    state.step = int(flat["step"])
    state.opt_state.count = int(flat[counts[0]])
    return state


class CheckpointSaver:
    """Epoch-end checkpoints as the JAX package's ``CheckpointSaver``
    writes them: ``{prefix}_config.yaml`` next to
    ``{prefix}_epoch_{e}.npz`` every ``save_every_n_epochs`` epochs and
    ``{prefix}_final.npz``, each a full train state."""

    def __init__(self, config, output_folder: str = "./checkpoints/",
                 filename_prefix: str = "clipcap", save_every_n_epochs: int = 1) -> None:
        from clipcap_tpu_torch.config import save_yaml_config

        self.output_folder = output_folder
        self.filename_prefix = filename_prefix
        self.save_every_n_epochs = max(1, save_every_n_epochs)
        os.makedirs(output_folder, exist_ok=True)
        save_yaml_config(config, os.path.join(output_folder, f"{filename_prefix}_config.yaml"))

    def _path(self, tag: str) -> str:
        return os.path.join(self.output_folder, f"{self.filename_prefix}_{tag}.npz")

    def on_epoch_end(self, epoch: int, state, tx) -> Optional[str]:
        if (epoch + 1) % self.save_every_n_epochs == 0:
            path = self._path(f"epoch_{epoch}")
            save_train_state(path, state, tx)
            return path
        return None

    def save_final_checkpoint(self, state, tx) -> str:
        path = self._path("final")
        save_train_state(path, state, tx)
        return path
