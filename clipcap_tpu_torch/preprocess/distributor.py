"""Distributors: run the preprocess partitions (counterpart of
``clipcap_tpu/preprocess/distributor.py``).

``MultiHostDistributor`` stripes partition ids across processes by rank:
the rank and world size of an initialised ``torch.distributed`` group, or
0 of 1 without one.  ``"pyspark"`` is an alias for it, for reference
command lines.
"""
from __future__ import annotations

import os


def process_index_count() -> tuple[int, int]:
    """(rank, world size) of this process; several processes without an
    initialised group raise, as the train CLI does."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise NotImplementedError("multi-process preprocess is not ported yet "
                                  "(ROADMAP.md A9): no torch.distributed group")
    return 0, 1


class SequentialDistributor:
    def __init__(self, runner, output_partition_count: int):
        self.runner = runner
        self.output_partition_count = output_partition_count

    def __call__(self) -> None:
        for i in range(self.output_partition_count):
            self.runner(i)


class MultiHostDistributor:
    """Partition ids striped across processes by rank."""

    def __init__(self, runner, output_partition_count: int):
        self.runner = runner
        self.output_partition_count = output_partition_count

    def __call__(self) -> None:
        index, count = process_index_count()
        for i in range(self.output_partition_count)[index::count]:
            self.runner(i)


def get_distributor(name: str, runner, output_partition_count: int):
    if name == "sequential":
        return SequentialDistributor(runner, output_partition_count)
    if name in ("multihost", "pyspark"):
        return MultiHostDistributor(runner, output_partition_count)
    raise ValueError(f"unknown distribution strategy '{name}'")
