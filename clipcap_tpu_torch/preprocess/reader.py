"""Readers: folder-of-files and webdataset tar shards → transformed batches.

The port's own copy of ``clipcap_tpu/preprocess/reader.py``:

* ``folder_to_keys``: stem-join of media files and ``.txt`` captions;
* ``FilesReader``: the joined keys, optionally from one shared scan;
* ``WebdatasetReader``: tar-shard streaming with key filtering and
  ``json_key/text_key`` caption paths; a bad sample or shard warns and the
  run continues;
* the collate that drops samples whose decode failed.

Decode and transform (PIL, which releases the GIL) run in a thread pool
with ordered reassembly and feed fixed-size numpy batches, so the next
batch decodes while the encoder runs on the card.  The webdataset reader
is stdlib ``tarfile`` + fsspec (local paths and remote URIs) instead of
the ``webdataset`` package.
"""
from __future__ import annotations

import io
import json
import tarfile
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def folder_to_keys(folder, media_file_extensions: Sequence[str]):
    """Stem-join media and caption files → (sorted keys, text files, media files)."""
    path = Path(folder)
    text_files = {f.stem: f for f in path.glob("**/*.txt")}
    media_files: Dict[str, Path] = {}
    for ext in media_file_extensions:
        for f in path.glob(f"**/*.{ext}"):
            media_files[f.stem] = f
    keys = sorted(set(text_files.keys()) & set(media_files.keys()))
    return keys, text_files, media_files


def _batched(iterable: Iterator, n: int) -> Iterator[list]:
    batch: list = []
    for item in iterable:
        batch.append(item)
        if len(batch) == n:
            yield batch
            batch = []
    if batch:
        yield batch


class _BatchAssembler:
    """Map ``sample_processor`` over raw samples with an ordered thread pool
    and assemble ``{"data_tensor": np[B,...], "text": [B]}`` batches, dropping
    samples whose decode fails (with a warning)."""

    def __init__(self, sample_processor: Callable, batch_size: int, workers: int):
        self.sample_processor = sample_processor
        self.batch_size = batch_size
        self.workers = max(1, workers)

    def __call__(self, raw_samples: Iterator[Tuple[object, str]]) -> Iterator[dict]:
        def process(item):
            raw, caption = item
            try:
                return self.sample_processor(raw), caption
            except Exception as e:
                warnings.warn(f"sample decode failed, skipping: {e}")
                return None

        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            done: list = []
            # chunked map keeps ordering and bounds memory to ~2 batches
            for chunk in _batched(raw_samples, self.batch_size * 2):
                for result in pool.map(process, chunk):
                    if result is None:
                        continue
                    done.append(result)
                    if len(done) == self.batch_size:
                        yield self._collate(done)
                        done = []
            if done:
                yield self._collate(done)

    @staticmethod
    def _collate(pairs: list) -> dict:
        tensors = np.stack([p[0] for p in pairs])
        texts = [p[1] for p in pairs]
        return {"data_tensor": tensors, "text": texts}


class FilesReader:
    """Folder of media + .txt caption files."""

    def __init__(
        self,
        sampler,
        sample_processor,
        input_dataset,
        media_file_extensions,
        batch_size,
        num_prepro_workers,
        precomputed_keys=None,
    ) -> None:
        # ``precomputed_keys``: the (keys, text_files, media_files) triple
        # from one shared ``folder_to_keys`` scan — a sequential run over N
        # partitions would otherwise walk the whole tree N+1 times
        # (dominant on network filesystems).
        keys, text_files, media_files = (
            precomputed_keys if precomputed_keys is not None
            else folder_to_keys(input_dataset, media_file_extensions))
        self.keys = sampler(keys)
        self.text_files = {k: text_files[k] for k in self.keys}
        self.media_files = {k: media_files[k] for k in self.keys}
        self.assembler = _BatchAssembler(sample_processor, batch_size, num_prepro_workers)

    def __len__(self) -> int:
        return len(self.keys)

    def _raw(self):
        for key in self.keys:
            yield str(self.media_files[key]), self.text_files[key].read_text()

    def __iter__(self) -> Iterator[dict]:
        yield from self.assembler(self._raw())


def _open_shard(url: str, cache_path: Optional[str] = None):
    """Open a tar shard as a file-like object. Local paths use plain open;
    remote URIs go through fsspec (with optional local cache dir)."""
    if "://" not in url:
        return open(url, "rb")
    import fsspec

    if cache_path:
        return fsspec.open(f"filecache::{url}", mode="rb",
                           filecache={"cache_storage": cache_path}).open()
    return fsspec.open(url, mode="rb").open()


def iterate_tar_samples(url: str, cache_path: Optional[str] = None) -> Iterator[Dict[str, bytes]]:
    """Stream grouped samples from one webdataset tar shard.

    Webdataset convention: files sharing a basename-before-first-dot belong
    to one sample; the extension (everything after the FIRST DOT OF THE
    BASENAME) is the key.  The split must ignore dots in directory
    components — ``./0001.jpg`` (tar -cf shard.tar .) and
    ``imgs.v2/0001.jpg`` group by ``0001`` with key ``jpg``, not by the
    pre-slash prefix (which would silently merge every member into one
    sample).
    """
    with _open_shard(url, cache_path) as f:
        with tarfile.open(fileobj=f, mode="r|*") as tar:
            current_key: Optional[str] = None
            sample: Dict[str, bytes] = {}
            for member in tar:
                if not member.isfile():
                    continue
                name = member.name
                dirname, _, fname = name.rpartition("/")
                stem, dot, ext = fname.partition(".")
                if not dot:
                    continue
                base = f"{dirname}/{stem}" if dirname else stem
                if base != current_key:
                    if sample:
                        yield sample
                    current_key = base
                    sample = {"__key__": base.encode()}
                data = tar.extractfile(member)
                if data is not None:
                    sample[ext] = data.read()
            if sample:
                yield sample


class WebdatasetReader:
    """Tar-shard streaming reader.  ``wds_caption_key`` also takes the
    ``json_key/text_key`` form for captions inside JSON metadata."""

    def __init__(
        self,
        sampler,
        sample_processor,
        input_dataset: List[str],
        batch_size: int,
        num_prepro_workers: int,
        wds_media_key: str = "jpg",
        wds_caption_key: str = "txt",
        cache_path: Optional[str] = None,
    ):
        self.urls = sampler(list(input_dataset))
        self.media_key = wds_media_key
        self.caption_key = wds_caption_key
        self.cache_path = cache_path
        self.assembler = _BatchAssembler(
            lambda raw: sample_processor(io.BytesIO(raw)), batch_size, num_prepro_workers
        )

    def _select(self, item: Dict[str, bytes]) -> bool:
        caption_container = self.caption_key.split("/")[0]
        return self.media_key in item and caption_container in item

    def _caption(self, item: Dict[str, bytes]) -> str:
        if "/" in self.caption_key:
            json_key, text_key = self.caption_key.split("/")
            caption = json.loads(item[json_key].decode("utf-8"))[text_key]
            if not isinstance(caption, str):
                raise ValueError("caption must be a string")
            return caption
        return item[self.caption_key].decode("utf-8")

    def _raw(self):
        for url in self.urls:
            try:
                for item in iterate_tar_samples(url, self.cache_path):
                    if not self._select(item):
                        continue
                    try:
                        yield item[self.media_key], self._caption(item)
                    except Exception as e:
                        warnings.warn(f"caption parse failed in {url}, skipping: {e}")
            except Exception as e:
                warnings.warn(f"shard {url} unreadable, skipping: {e}")

    def __iter__(self) -> Iterator[dict]:
        yield from self.assembler(self._raw())
