"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic file (``traffic/<name>.json``) names its ``kind`` and the sizes
of what it sends; this module turns it and ``--seed`` into the inputs of
the run: ``distinct`` batches made on the device from the seed at set-up,
which the closed loop then cycles.  Every seed gives the same sizes; only
the values differ.

* ``images``: uint8 ``[batch, size, size, 3]`` images, staged in host
  memory (numpy), as a data loader hands them to the encoder.
* ``train``: ``[batch, embed]`` float32 embeddings and ``[batch, tokens]``
  caption ids drawn from ``[1, eos)``, each row's length uniform in
  ``[min_tokens, tokens]``, padded with -1; kept on the device.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from portbench.weights import sub_seed

HERE = Path(__file__).resolve().parent


def load(name: str) -> dict:
    return json.loads((HERE / f"{name}.json").read_text())


def _gen(seed: int, i: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, f"inputs:{i}"))


def images(traffic: dict, size: int, seed: int, device) -> list:
    """``distinct`` uint8 image batches as numpy arrays in host memory."""
    out = []
    for i in range(traffic["distinct"]):
        x = torch.randint(0, 256, (traffic["batch"], size, size, 3), generator=_gen(seed, i, device),
                          device=device, dtype=torch.uint8)
        out.append(x.cpu().numpy())
    return out


def train(traffic: dict, embed_dim: int, eos: int, seed: int, device) -> list:
    """``distinct`` (tokens, embeddings) batches on the device."""
    B, T = traffic["batch"], traffic["tokens"]
    out = []
    for i in range(traffic["distinct"]):
        g = _gen(seed, i, device)
        emb = torch.randn(B, embed_dim, generator=g, device=device)
        ids = torch.randint(1, eos, (B, T), generator=g, device=device)
        lengths = torch.randint(traffic["min_tokens"], T + 1, (B, 1), generator=g, device=device)
        pad = torch.arange(T, device=device)[None, :] >= lengths
        out.append((ids.masked_fill(pad, -1), emb))
    return out
