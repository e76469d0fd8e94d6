"""CLIP text tokenizer (the ``open_clip.tokenize`` analog used for rerank).

The port's own copy of ``clipcap_tpu/utils/clip_tokenizer.py``.

Reads the standard ``bpe_simple_vocab_16e6.txt.gz`` merges file from a local
path (``CLIPCAP_CLIP_BPE_PATH`` or ``~/.cache/clip/``); offline without it,
falls back to a hash-bucket tokenizer so the rerank path still executes
(meaningless similarities under random weights anyway — a warning says so).
"""
from __future__ import annotations

import gzip
import os
import warnings
from functools import lru_cache
from typing import List, Optional, Sequence

import numpy as np

try:
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re

from clipcap_tpu_torch.utils.tokenizer import bytes_to_unicode

CONTEXT_LENGTH = 77

_PAT = _re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+""",
    _re.IGNORECASE,
)


def _basic_clean(text: str) -> str:
    return text.strip()


def _whitespace_clean(text: str) -> str:
    return _re.sub(r"\s+", " ", text).strip()


class CLIPBPETokenizer:
    """OpenAI CLIP's lowercase byte-BPE with </w> word-end markers."""

    def __init__(self, bpe_path: str):
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not word:
            return token + "</w>"
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            if not pairs:
                break
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for tok in _re.findall(_PAT, text):
            if tok in ("<|startoftext|>", "<|endoftext|>"):
                ids.append(self.encoder[tok])
                continue
            mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return ids


class _HashTokenizer:
    """Offline fallback: deterministic hash buckets in the CLIP vocab range."""

    def __init__(self, vocab_size: int = 49408):
        warnings.warn(
            "CLIP BPE merges file not found — using a hash-bucket fallback "
            "tokenizer. Rerank similarities will not match real CLIP; place "
            "bpe_simple_vocab_16e6.txt.gz at $CLIPCAP_CLIP_BPE_PATH or "
            "~/.cache/clip/ for exact behavior."
        )
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1
        self._n = vocab_size - 2

    def encode(self, text: str) -> List[int]:
        import hashlib

        out = []
        for w in text.lower().split():
            h = int(hashlib.md5(w.encode()).hexdigest(), 16)
            out.append(1 + (h % (self._n - 1)))
        return out


@lru_cache()
def _resolve_tokenizer():
    for candidate in (
        os.environ.get("CLIPCAP_CLIP_BPE_PATH"),
        os.path.expanduser("~/.cache/clip/bpe_simple_vocab_16e6.txt.gz"),
    ):
        if candidate and os.path.exists(candidate):
            return CLIPBPETokenizer(candidate)
    return _HashTokenizer()


def tokenize(texts: Sequence[str], context_length: int = CONTEXT_LENGTH) -> np.ndarray:
    """open_clip.tokenize-compatible: [N, 77] int32, sot + ids + eot, 0-pad,
    long texts truncated with eot preserved."""
    if isinstance(texts, str):
        texts = [texts]
    tok = _resolve_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [tok.sot] + tok.encode(text) + [tok.eot]
        if len(ids) > context_length:
            ids = ids[: context_length - 1] + [tok.eot]
        out[i, : len(ids)] = ids
    return out
