"""Tiny cells of the benchmark on the CPU: the port's plain twins stand in
for the kernels, and the harness runs without its look for a card.

A tiny model's bf16 errors are not a full one's (fewer, narrower layers
average less), so the tiny cells hold their own limits, set the way the
cells' are: above what sound tiny runs read on a dozen seeds, below what
the float8 control reads (``TINY_LIMITS``).  The cells' limits come from
readings on the chip at the cells' sizes (``PERF.md``)."""
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

from portbench import harness  # noqa: E402
from portbench.traffic import generate  # noqa: E402

# The tiny traffic of each kind: the cell's own mix, cut to CPU sizes.
TINY_TRAFFIC = {
    "caption": ("caption.b128", {"batch": 4, "distinct": 2, "max_new_tokens": 6}),
    "embed": ("embed.b256", {"batch": 4, "distinct": 2}),
    "train": ("train.b64", {"batch": 4, "distinct": 3, "tokens": 6, "min_tokens": 2}),
}
TINY_LIMITS = {
    "caption": {"embed_rel": 0.015, "prefix_rel": 0.02, "score_err": 0.006, "rank_gap": 0.012},
    "embed": {"embed_rel": 0.015},
    "train": {"loss_rel": 2e-4, "grad_gap": 0.05, "update_gap": 0.03},
}
CELLS = {"caption": "caption.vitb32-gpt2.b128", "embed": "embed.vitl14.b256",
         "train": "train.vitl14-gpt2xl.b64"}


def tiny_files(kind: str, **spec) -> SimpleNamespace:
    """The files of a tiny cell of ``kind``: the tiny configuration, the
    kind's traffic cut to CPU sizes, the full cell's check spec with the
    tiny limits."""
    import importlib

    name, cut = TINY_TRAFFIC[kind]
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    real = harness.cell_files(bench, CELLS[kind])
    cell_spec = dict(real.spec, limits=TINY_LIMITS[kind], **spec)
    if "check_images" in cell_spec:
        cell_spec["check_images"] = min(cell_spec["check_images"], 4)
    return SimpleNamespace(entry={"name": f"tiny.{kind}", "chips": 1},
                           cfg=json.loads((HERE / "tiny.json").read_text()),
                           traffic=dict(generate.load(name), **cut), spec=cell_spec,
                           kind=importlib.import_module(f"portbench.kinds.{kind}"))


def run_tiny(kind: str, seed: int = 123456789012):
    files = tiny_files(kind)
    args = SimpleNamespace(seed=seed, seconds=0.0, trace=0)
    bench = {"end_to_end": [], "per_layer": []}
    return harness.run_cell(files, bench, args, torch.device("cpu"), 0.0)


@pytest.fixture
def tiny():
    return run_tiny
