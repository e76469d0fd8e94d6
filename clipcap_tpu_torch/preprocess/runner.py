"""Runner: drive reader → mapper → writer for one output partition
(counterpart of ``clipcap_tpu/preprocess/runner.py``).

The reader's thread pool decodes the next batch while the mapper's
forward runs on the card; each partition prints where its wall clock went
(read/decode, encode, write).
"""
from __future__ import annotations

from typing import Callable, List, Sequence

from clipcap_tpu_torch.utils.profiling import Timer


class Sampler:
    """Partition i takes every count-th input."""

    def __init__(self, output_partition_id: int, output_partition_count: int):
        self.output_partition_id = output_partition_id
        self.output_partition_count = output_partition_count

    def __call__(self, items: Sequence) -> List:
        return [
            e for i, e in enumerate(items)
            if i % self.output_partition_count == self.output_partition_id
        ]


class Runner:
    def __init__(self, reader_builder: Callable, mapper_builder: Callable,
                 writer_builder: Callable, output_partition_count: int):
        self.reader_builder = reader_builder
        self.mapper_builder = mapper_builder
        self.writer_builder = writer_builder
        self.output_partition_count = output_partition_count

    def __call__(self, i: int) -> None:
        sampler = Sampler(i, self.output_partition_count)
        reader = self.reader_builder(sampler)
        writer = self.writer_builder(i)
        mapper = self.mapper_builder()

        timer = Timer()
        samples = 0
        it = iter(reader)
        while True:
            with timer.section("read/decode"):
                batch = next(it, None)
            if batch is None:
                break
            with timer.section("encode"):
                embeddings = mapper(batch)
            with timer.section("write"):
                writer(embeddings)
            samples += len(embeddings["text"])
        with timer.section("write"):
            writer.flush()
        totals = timer.summary()
        wall = max(sum(totals.values()), 1e-9)
        parts = ", ".join(f"{k} {v:.1f}s" for k, v in totals.items())
        print(f"partition {i}: {samples} samples in {wall:.1f}s "
              f"({samples / wall:.1f}/s; {parts})")
