"""Streaming embedding reader — the framework's ``embedding_reader`` equivalent.

The port's own copy of ``clipcap_tpu/train/reader.py``.  The reference
trains from ``EmbeddingReader(embeddings_folder, metadata_folder,
"parquet_npy", meta_columns=['caption'])``, a vendored fork of
rom1504/embedding-reader.  This is the same on-disk contract — paired
``embeddings/embeds_<NNN>.npy`` + ``captions/captions_<NNN>.parquet`` files
written by either package's preprocess stage (and byte-compatible with files the
PyTorch reference wrote) — re-implemented as a host-side streaming reader:

* piece-wise reads with a bounded background prefetch pool
  (``parallel_pieces`` analog) so the device never waits on disk;
* batches cross file boundaries, exactly like embedding-reader;
* ``start``/``end``/``count`` slicing for mid-epoch resume;
* multi-host sharding hook (each process reads a disjoint row range).
"""
from __future__ import annotations

import os
import re
import threading
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _read_parquet_column(path: str, column: str) -> List[str]:
    import pandas as pd

    return pd.read_parquet(path, columns=[column])[column].astype(str).tolist()


@dataclass(frozen=True)
class _Piece:
    npy_path: str
    parquet_path: str
    count: int


def _numeric_suffix(name: str) -> int:
    m = re.search(r"(\d+)", os.path.basename(name))
    return int(m.group(1)) if m else -1


class EmbeddingReader:
    """Paired npy/parquet streaming reader.

    Parameters mirror the reference call site (train/dataloader.py:32-38,
    52-56): ``embeddings_folder``, ``metadata_folder``, ``meta_columns``.
    ``dimension`` and ``count`` are discovered from the files (headers only —
    no data is loaded at construction).
    """

    def __init__(
        self,
        embeddings_folder: str,
        metadata_folder: str,
        file_format: str = "parquet_npy",
        meta_columns: Sequence[str] = ("caption",),
    ) -> None:
        if file_format != "parquet_npy":
            raise ValueError("only 'parquet_npy' is supported (reference contract)")
        self.meta_columns = list(meta_columns)

        npys = sorted(
            (os.path.join(embeddings_folder, f) for f in os.listdir(embeddings_folder)
             if f.endswith(".npy")),
            key=_numeric_suffix,
        )
        pqs = sorted(
            (os.path.join(metadata_folder, f) for f in os.listdir(metadata_folder)
             if f.endswith(".parquet")),
            key=_numeric_suffix,
        )
        if len(npys) != len(pqs):
            raise ValueError(
                f"mismatched piece counts: {len(npys)} npy vs {len(pqs)} parquet"
            )
        if not npys:
            raise ValueError(f"no .npy files in {embeddings_folder}")

        self.pieces: List[_Piece] = []
        dim: Optional[Tuple[int, ...]] = None
        for npy, pq in zip(npys, pqs):
            shape, _ = _npy_header(npy)
            if dim is None:
                dim = tuple(shape[1:])
            elif tuple(shape[1:]) != dim:
                raise ValueError(f"inconsistent embedding dims: {shape[1:]} vs {dim}")
            self.pieces.append(_Piece(npy, pq, int(shape[0])))

        self.count = sum(p.count for p in self.pieces)
        # reference exposes reader.dimension = embedding size (dataloader.py:39)
        self.dimension = int(dim[-1])
        self.embedding_shape = dim  # (E,) or (W, E) for windowed datasets

    def __call__(
        self,
        batch_size: int,
        start: int = 0,
        end: Optional[int] = None,
        max_piece_size: int = 50_000,
        parallel_pieces: int = 4,
        show_progress: bool = False,
    ) -> Iterator[Tuple[np.ndarray, dict]]:
        """Yield ``(embeddings[B], metadata dict of lists)`` batches.

        The [start, end) row range is split into chunks of at most
        ``max_piece_size`` rows (so one in-flight unit is bounded no matter
        how large the on-disk pieces are) and loaded by a
        ``parallel_pieces``-worker thread pool with a bounded ordered
        window — disk reads overlap each other AND the consumer; batches
        span chunk/piece boundaries.
        """
        end = self.count if end is None else min(end, self.count)
        if start >= end:
            return

        # Map the [start, end) row range onto pieces, then onto row chunks.
        chunks: List[Tuple[_Piece, int, int]] = []  # (piece, lo, hi) local
        offset = 0
        step = max(1, int(max_piece_size))
        for p in self.pieces:
            lo = max(start - offset, 0)
            hi = min(end - offset, p.count)
            for c0 in range(lo, hi, step):
                chunks.append((p, c0, min(c0 + step, hi)))
            offset += p.count
            if offset >= end:
                break

        # Caption columns are stored one whole column per piece: memoize the
        # two most recent so consecutive chunks of a piece do not re-read it,
        # without holding every in-flight piece's column.
        col_cache: "OrderedDict[str, dict]" = OrderedDict()
        cache_lock = threading.Lock()

        def columns(piece: _Piece) -> dict:
            with cache_lock:
                if piece.parquet_path in col_cache:
                    col_cache.move_to_end(piece.parquet_path)
                    return col_cache[piece.parquet_path]
            cols = {c: _read_parquet_column(piece.parquet_path, c)
                    for c in self.meta_columns}
            with cache_lock:
                col_cache[piece.parquet_path] = cols
                while len(col_cache) > max(2, parallel_pieces):
                    col_cache.popitem(last=False)
            return cols

        def load(piece: _Piece, lo: int, hi: int):
            emb = np.asarray(np.load(piece.npy_path, mmap_mode="r")[lo:hi])
            cols = columns(piece)
            return emb, {c: cols[c][lo:hi] for c in self.meta_columns}

        buf_emb: List[np.ndarray] = []
        buf_meta: List[dict] = []
        buffered = 0
        window = max(2, parallel_pieces)
        with ThreadPoolExecutor(max_workers=max(1, parallel_pieces)) as pool:
            pending: "deque" = deque()
            it = iter(chunks)

            def refill():
                while len(pending) < window:
                    nxt = next(it, None)
                    if nxt is None:
                        return
                    pending.append(pool.submit(load, *nxt))

            refill()
            while pending:
                emb, meta = pending.popleft().result()
                refill()
                buf_emb.append(emb)
                buf_meta.append(meta)
                buffered += emb.shape[0]
                while buffered >= batch_size:
                    yield self._pop_batch(buf_emb, buf_meta, batch_size)
                    buffered -= batch_size
            if buffered:
                yield self._pop_batch(buf_emb, buf_meta, buffered)

    def _pop_batch(self, buf_emb, buf_meta, n):
        out_emb: List[np.ndarray] = []
        out_meta = {c: [] for c in self.meta_columns}
        need = n
        while need > 0:
            emb, meta = buf_emb[0], buf_meta[0]
            take = min(need, emb.shape[0])
            out_emb.append(emb[:take])
            for c in self.meta_columns:
                out_meta[c].extend(meta[c][:take])
            if take == emb.shape[0]:
                buf_emb.pop(0)
                buf_meta.pop(0)
            else:
                buf_emb[0] = emb[take:]
                buf_meta[0] = {c: meta[c][take:] for c in self.meta_columns}
            need -= take
        return np.concatenate(out_emb, axis=0), out_meta


def _npy_header(path: str) -> Tuple[Tuple[int, ...], np.dtype]:
    """Read shape/dtype from a .npy header without loading data."""
    with open(path, "rb") as f:
        version = np.lib.format.read_magic(f)
        if version == (1, 0):
            shape, _, dtype = np.lib.format.read_array_header_1_0(f)
        else:
            shape, _, dtype = np.lib.format.read_array_header_2_0(f)
    return shape, dtype
