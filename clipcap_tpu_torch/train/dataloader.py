"""Training dataloader: streaming embeddings → ``(tokens, embeds)`` batches.

Counterpart of ``clipcap_tpu/train/dataloader.py`` on one process: the
captions are tokenized and padded to ``MAX_TOKEN_LENGTH`` (64) with -1
pads, longer ones cut; the final partial batch is padded with all-pad rows
(zero loss weight) so every batch has one shape; a background thread
prepares the next batch while the current one trains.  Batches are numpy
arrays in the JAX package's order; moving them to the device is the
training loop's job.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Iterator, List, Tuple

import numpy as np

from clipcap_tpu_torch.utils.tokenizer import get_tokenizer
from clipcap_tpu_torch.train.reader import EmbeddingReader


# Tokens per caption: longer ones are cut, shorter ones padded with -1.
MAX_TOKEN_LENGTH = 64


class EmbedDataset:
    """The whole dataset in the reader's order, in batches of ``batch_size``;
    the final partial batch is padded with all-pad rows."""

    def __init__(self, data_path: str = "./dataset/", language_model: str = "gpt2-xl",
                 batch_size: int = 256, reader_max_piece_size: int = 50,
                 reader_parallel_pieces: int = 10, tokenizer=None) -> None:
        self.tokenizer = tokenizer if tokenizer is not None else get_tokenizer(language_model)
        self.batch_size = batch_size
        self.reader_max_piece_size = reader_max_piece_size
        self.reader_parallel_pieces = reader_parallel_pieces
        if not data_path.endswith("/"):
            data_path += "/"
        self.reader = EmbeddingReader(embeddings_folder=data_path + "embeddings",
                                      metadata_folder=data_path + "captions",
                                      file_format="parquet_npy", meta_columns=["caption"])
        self.encoder_embedding_size = self.reader.dimension

    @staticmethod
    def _pad_tokens(ids: List[int]) -> np.ndarray:
        out = np.full((MAX_TOKEN_LENGTH,), -1, dtype=np.int32)
        ids = ids[:MAX_TOKEN_LENGTH]
        out[: len(ids)] = ids
        return out

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        B = self.batch_size
        for embeds, meta in self.reader(batch_size=B, max_piece_size=self.reader_max_piece_size,
                                        parallel_pieces=self.reader_parallel_pieces):
            token_lists = self.tokenizer.batch_encode_plus(meta["caption"])["input_ids"]
            tokens = np.stack([self._pad_tokens(t) for t in token_lists])
            embeds = np.asarray(embeds, dtype=np.float32)
            if tokens.shape[0] < B:
                n = B - tokens.shape[0]
                tokens = np.concatenate([tokens, np.full((n, MAX_TOKEN_LENGTH), -1, np.int32)])
                embeds = np.concatenate([embeds, np.zeros((n,) + embeds.shape[1:],
                                                          np.float32)])
            yield tokens, embeds

    def __len__(self) -> int:
        return math.ceil(self.reader.count / self.batch_size)


class PrefetchLoader:
    """Iterate a dataset in a background thread, at most ``prefetch``
    batches ahead.  A producer error is raised in the consumer; leaving
    the loop early stops the thread."""

    def __init__(self, dataset, prefetch: int = 2):
        self.dataset = dataset
        self.prefetch = prefetch

    def __len__(self):
        return len(self.dataset)

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        done = object()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                for item in self.dataset:
                    if not put(item):
                        return
                put(done)
            except Exception as e:   # raised again in the consumer
                put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is done:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join(timeout=10)


def get_dataloader(data_path: str = "./dataset/", language_model: str = "gpt2-xl",
                   batch_size: int = 256, tokenizer=None,
                   **kwargs) -> Tuple[PrefetchLoader, int]:
    """The loader and the encoder embedding size found in the data."""
    dataset = EmbedDataset(data_path=data_path, language_model=language_model,
                           batch_size=batch_size, tokenizer=tokenizer, **kwargs)
    return PrefetchLoader(dataset), dataset.encoder_embedding_size
