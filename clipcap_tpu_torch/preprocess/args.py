"""Preprocess CLI args: the port's own copy of
``clipcap_tpu/preprocess/args.py``.

``--device`` defaults to ``cuda`` (a torch device; a CUDA device raises
when CUDA is absent).  ``multihost`` and ``pyspark`` stay as choices: they
stripe partitions across the processes of an initialised
``torch.distributed`` group.
"""
from argparse import ArgumentParser


def add_preprocess_args(parser: ArgumentParser) -> ArgumentParser:
    parser.add_argument(
        "--input-dataset", type=str, default=None,
        help="path to the training dataset (local or remote). For webdatasets, "
             "comma-separate multiple braced uris.",
    )
    parser.add_argument(
        "--output-folder", type=str, default=None,
        help="output path to store the preprocessed data.",
    )
    parser.add_argument(
        "--input-format", choices=["files", "webdataset"], type=str, default="files",
        help="'files' for a folder of media + .txt captions, or 'webdataset' tar shards",
    )
    parser.add_argument("--batch-size", type=int, default=256,
                        help="number of samples to process in each batch")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to generate embeds on")
    parser.add_argument(
        "--distribution-strategy",
        choices=["sequential", "multihost", "pyspark"], type=str, default="sequential",
        help="'sequential' runs partitions in order; 'multihost' stripes them "
             "across the processes of a torch.distributed group ('pyspark' = alias).",
    )
    parser.add_argument("--workers", type=int, default=8,
                        help="decode worker threads for the reader")
    parser.add_argument("--write-batch-size", type=int, default=10**6,
                        help="max number of processed samples to store at once")
    parser.add_argument("--output-partition-count", type=int, default=None,
                        help="number of output partitions")

    wds = parser.add_argument_group("--input-format=webdataset")
    wds.add_argument("--wds-media-key", type=str, default="jpg",
                     help="[webdataset] key of the content to be embedded")
    wds.add_argument("--wds-caption-key", type=str, default="txt",
                     help="[webdataset] caption key; 'json_key/text_key' reads "
                          "captions from json metadata, e.g. 'json/caption'.")
    wds.add_argument("--wds-samples-per-file", type=int, default=10_000,
                     help="[webdataset] samples per .tar (for partition estimation)")
    wds.add_argument("--wds-cache-path", type=str, default=None,
                     help="[webdataset] local shard cache path (optional)")

    files = parser.add_argument_group("--input-format=files")
    files.add_argument("--media-file-extensions", type=str, default="png,jpg,jpeg,bmp",
                       help="[files] comma-separated media extensions, e.g. 'mp3,wav'.")
    return parser
