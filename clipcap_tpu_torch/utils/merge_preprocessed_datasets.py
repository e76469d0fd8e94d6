"""Merge preprocessed dataset folders into one.

Counterpart of ``clipcap_tpu/utils/merge_preprocessed_datasets.py``: the
preprocess layout (``embeddings/embeds_*.npy``, ``captions/captions_*.parquet``,
``encoder_config.yaml``), partitions renumbered in order, and a refusal
to merge datasets whose encoder configs differ.

Usage:
    python -m clipcap_tpu_torch.utils.merge_preprocessed_datasets \\
        --folders ds_a ds_b --output-folder merged [--move]
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
from typing import List

import yaml


def _sorted_parts(folder: str, suffix: str) -> List[str]:
    files = [f for f in os.listdir(folder) if f.endswith(suffix)]

    def num(name):
        m = re.search(r"(\d+)", name)
        return int(m.group(1)) if m else -1

    return sorted(files, key=num)


def merge_datasets(folders: List[str], output_folder: str, move: bool = False) -> int:
    os.makedirs(os.path.join(output_folder, "embeddings"), exist_ok=True)
    os.makedirs(os.path.join(output_folder, "captions"), exist_ok=True)

    base_config = None
    total_parts = 0
    plan = []  # (src_npy, src_parquet)
    for folder in folders:
        cfg_path = os.path.join(folder, "encoder_config.yaml")
        if os.path.exists(cfg_path):
            with open(cfg_path) as f:
                cfg = yaml.safe_load(f)
            if base_config is None:
                base_config = cfg
            elif cfg != base_config:
                raise ValueError(
                    f"encoder_config.yaml mismatch between {folders[0]} and {folder}; "
                    "refusing to merge datasets from different encoders")
        npys = _sorted_parts(os.path.join(folder, "embeddings"), ".npy")
        pqs = _sorted_parts(os.path.join(folder, "captions"), ".parquet")
        if len(npys) != len(pqs):
            raise ValueError(f"{folder}: {len(npys)} npy vs {len(pqs)} parquet pieces")
        plan += [(os.path.join(folder, "embeddings", n), os.path.join(folder, "captions", p))
                 for n, p in zip(npys, pqs)]
        total_parts += len(npys)

    width = max(1, len(str(total_parts - 1)))
    op = shutil.move if move else shutil.copy2
    for i, (npy, pq) in enumerate(plan):
        tag = str(i).zfill(width)
        op(npy, os.path.join(output_folder, "embeddings", f"embeds_{tag}.npy"))
        op(pq, os.path.join(output_folder, "captions", f"captions_{tag}.parquet"))

    if base_config is not None:
        with open(os.path.join(output_folder, "encoder_config.yaml"), "w") as f:
            yaml.dump(base_config, f, default_flow_style=False)
    print(f"merged {total_parts} partitions from {len(folders)} datasets into {output_folder}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--folders", nargs="+", required=True,
                        help="preprocessed dataset folders to merge, in order")
    parser.add_argument("--output-folder", required=True)
    parser.add_argument("--move", action="store_true",
                        help="move files instead of copying")
    args = parser.parse_args(argv)
    return merge_datasets(args.folders, args.output_folder, move=args.move)


if __name__ == "__main__":
    exit(main())
