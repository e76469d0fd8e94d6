"""Preprocess orchestrator — ``python -m clipcap_tpu_torch.preprocess``.

Counterpart of ``clipcap_tpu/preprocess/preprocess.py``, with the same
flags and defaults except ``--device`` (a torch device, ``cuda`` by
default; without CUDA it raises).  Brace-expand webdataset URIs → build
the encoder and save its config → one directory scan for files input →
partition count = ceil(samples / write_batch_size) → reader, mapper and
writer under the Runner → run under the chosen distributor.  The dataset
it writes (``encoder_config.yaml``, ``embeddings/embeds_<NNN>.npy``,
``captions/captions_<NNN>.parquet``) trains in either package.
"""
from __future__ import annotations

import math
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser, Namespace

from clipcap_tpu_torch.config import EncoderConfig
from clipcap_tpu_torch.encoders.args import add_encoder_args
from clipcap_tpu_torch.encoders.base import get_encoder_from_config
from clipcap_tpu_torch.preprocess.args import add_preprocess_args
from clipcap_tpu_torch.preprocess.distributor import get_distributor
from clipcap_tpu_torch.preprocess.mapper import EncoderMapper
from clipcap_tpu_torch.preprocess.reader import FilesReader, WebdatasetReader, folder_to_keys
from clipcap_tpu_torch.preprocess.runner import Runner
from clipcap_tpu_torch.preprocess.writer import PartitionWriter, write_encoder_config
from clipcap_tpu_torch.utils.braceexpand import braceexpand


def _partition_count(args: Namespace, input_dataset, folder_keys) -> int:
    """Number of output partitions: explicit override, or an estimate of
    the sample count divided into ``write_batch_size``-sized partitions.
    ``folder_keys`` is the run's one directory scan (files input).  Raises
    ``ValueError`` when the input yields no samples to estimate from."""
    if args.output_partition_count is not None:
        return args.output_partition_count
    if args.input_format == "files":
        estimate = len(folder_keys[0])
    else:  # webdataset: tar count x nominal samples per tar
        estimate = len(input_dataset) * args.wds_samples_per_file
    if estimate == 0:
        raise ValueError(f"no input samples under {input_dataset!r}")
    count = math.ceil(estimate / args.write_batch_size)
    print(f"preprocess: ~{estimate} samples -> {count} output partition(s) "
          f"of <= {args.write_batch_size}")
    return count


def preprocess(args: Namespace) -> int:
    if args.input_format not in ("files", "webdataset"):
        print(f"preprocess: unknown --input-format {args.input_format!r} "
              "(expected files|webdataset)")
        return 1
    if args.input_format == "webdataset":
        datasets = args.input_dataset.split(",")
        input_dataset = [uri for dataset in datasets for uri in braceexpand(dataset)]
    else:
        input_dataset = args.input_dataset

    encoder_config = EncoderConfig.from_args(args)
    try:
        encoder_model, sample_processor = get_encoder_from_config(
            encoder_config, device=args.device, int8=getattr(args, "int8_encoder", False))
    except ValueError as e:
        print(f"preprocess: {e}")
        return 1
    # Record the embedding width up front (train still checks it against
    # the data).
    if getattr(encoder_model, "embedding_size", None):
        encoder_config.encoder_embedding_size = encoder_model.embedding_size
    write_encoder_config(encoder_config, args.output_folder)

    # ONE directory scan for the whole run: partition estimation and every
    # per-partition FilesReader share it.
    folder_keys = None
    if args.input_format == "files":
        folder_keys = folder_to_keys(
            input_dataset, args.media_file_extensions.lower().split(","))
    try:
        output_partition_count = _partition_count(args, input_dataset, folder_keys)
    except ValueError as e:
        print(f"preprocess: {e}")
        return 1

    def reader_builder(sampler):
        if args.input_format == "files":
            return FilesReader(
                sampler, sample_processor, input_dataset,
                args.media_file_extensions.lower().split(","),
                args.batch_size, args.workers,
                precomputed_keys=folder_keys,
            )
        return WebdatasetReader(
            sampler, sample_processor, input_dataset,
            args.batch_size, args.workers,
            wds_media_key=args.wds_media_key,
            wds_caption_key=args.wds_caption_key,
            cache_path=args.wds_cache_path,
        )

    def mapper_builder():
        return EncoderMapper(model=encoder_model)

    def writer_builder(i):
        return PartitionWriter(
            partition_id=i,
            output_folder=args.output_folder,
            output_partition_count=output_partition_count,
        )

    runner = Runner(
        reader_builder=reader_builder,
        mapper_builder=mapper_builder,
        writer_builder=writer_builder,
        output_partition_count=output_partition_count,
    )
    get_distributor(args.distribution_strategy, runner, output_partition_count)()
    return 0


def start_preprocess(argv=None) -> int:
    """The CLI: parse ``argv`` (default: the command line) and preprocess.
    Several processes are not set up here (ROADMAP.md A9)."""
    parser = ArgumentParser(description=__doc__, formatter_class=ArgumentDefaultsHelpFormatter)
    parser = add_preprocess_args(parser)
    parser = add_encoder_args(parser)
    return preprocess(parser.parse_args(argv))


if __name__ == "__main__":
    exit(start_preprocess())
