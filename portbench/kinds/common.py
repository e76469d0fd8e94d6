"""Helpers the kinds share."""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def patched(module, name: str, value):
    """``module.name`` replaced for the block (a span around an entry)."""
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, orig)


def blocks(fn, x: torch.Tensor, rows: int) -> torch.Tensor:
    """``fn`` over ``x`` in blocks of ``rows``, concatenated."""
    return torch.cat([fn(x[i:i + rows]) for i in range(0, x.shape[0], rows)])


def worst_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest per-sample relative L2 error ‖got − want‖ / ‖want‖ over
    the leading axis."""
    got, want = got.float().flatten(1), want.float().flatten(1)
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
