"""GPT-2 byte-level BPE tokenizer — self-contained, no network required.

The port's own copy of ``clipcap_tpu/utils/tokenizer.py``: the same ids.
The reference gets its tokenizer from HF hub downloads
(``AutoTokenizer.from_pretrained``).
This implementation reads the same ``vocab.json`` + ``merges.txt`` artifact
format from a local path (or via transformers when the hub is reachable),
so existing GPT-2 tokenizer files drop in unchanged.

Offline without tokenizer files, ``get_tokenizer`` falls back to a raw
byte-level tokenizer (ids = byte values, eos = 50256) so smoke tests and
benchmarks still run; it warns loudly since captions would differ from a
real GPT-2 vocabulary.
"""
from __future__ import annotations

import json
import os
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

try:
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re

_PAT = _re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte↔unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


class GPT2Tokenizer:
    """Byte-level BPE matching HF's slow GPT-2 tokenizer."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[str],
                 eos_token: str = "<|endoftext|>"):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        ranked = [tuple(m.split()) for m in merges if m and not m.startswith("#")]
        self.bpe_ranks = {pair: i for i, pair in enumerate(ranked)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: Dict[str, str] = {}
        self.eos_token = eos_token
        self.bos_token = eos_token
        self.eos_token_id = self.encoder[eos_token]
        self.bos_token_id = self.eos_token_id
        self.vocab_size = len(self.encoder)

    @classmethod
    def from_files(cls, vocab_file: str, merges_file: str) -> "GPT2Tokenizer":
        with open(vocab_file, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_file, encoding="utf-8") as f:
            merges = f.read().split("\n")
        if merges and merges[0].startswith("#"):
            merges = merges[1:]
        return cls(vocab, merges)

    @classmethod
    def from_dir(cls, path: str) -> "GPT2Tokenizer":
        return cls.from_files(os.path.join(path, "vocab.json"),
                              os.path.join(path, "merges.txt"))

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        if len(word) <= 1:
            self.cache[token] = token
            return token
        while True:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
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
        # Special token handling: split on eos occurrences first.
        parts = text.split(self.eos_token)
        for i, part in enumerate(parts):
            if i > 0:
                ids.append(self.eos_token_id)
            for tok in _re.findall(_PAT, part):
                mapped = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
                ids.extend(self.encoder[t] for t in self._bpe(mapped).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder.get(int(i), "") for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        # Special tokens pass through byte-decoding untouched.
        out = raw.decode("utf-8", errors="replace")
        # Re-insert special tokens that were lost (chars not in byte_decoder).
        if self.eos_token in text:
            # rebuild carefully: walk the symbol string
            pieces: List[str] = []
            buf: List[int] = []
            i = 0
            while i < len(text):
                if text.startswith(self.eos_token, i):
                    if buf:
                        pieces.append(bytes(buf).decode("utf-8", errors="replace"))
                        buf = []
                    pieces.append(self.eos_token)
                    i += len(self.eos_token)
                else:
                    c = text[i]
                    if c in self.byte_decoder:
                        buf.append(self.byte_decoder[c])
                    i += 1
            if buf:
                pieces.append(bytes(buf).decode("utf-8", errors="replace"))
            return "".join(pieces)
        return out

    def batch_encode(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    # transformers-compatible sugar used across the pipeline
    def batch_encode_plus(self, texts: Sequence[str]) -> Dict[str, List[List[int]]]:
        return {"input_ids": self.batch_encode(texts)}

    def __call__(self, text):
        if isinstance(text, str):
            return {"input_ids": self.encode(text)}
        return self.batch_encode_plus(text)


class ByteTokenizer:
    """Offline fallback: ids are raw bytes; eos uses GPT-2's id 50256 so the
    LM head shape stays GPT-2-compatible. Warns at construction."""

    def __init__(self, eos_token_id: int = 50256):
        import warnings

        warnings.warn(
            "Using byte-level fallback tokenizer (no GPT-2 vocab files found). "
            "Token ids will NOT match a pretrained GPT-2."
        )
        self.eos_token = "<|endoftext|>"
        self.bos_token = self.eos_token
        self.eos_token_id = eos_token_id
        self.bos_token_id = eos_token_id
        self.vocab_size = 50257

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        parts = text.split(self.eos_token)
        for i, part in enumerate(parts):
            if i > 0:
                ids.append(self.eos_token_id)
            ids.extend(part.encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[str] = []
        buf: List[int] = []
        for i in ids:
            i = int(i)
            if i == self.eos_token_id:
                if buf:
                    out.append(bytes(buf).decode("utf-8", errors="replace"))
                    buf = []
                out.append(self.eos_token)
            elif 0 <= i < 256:
                buf.append(i)
        if buf:
            out.append(bytes(buf).decode("utf-8", errors="replace"))
        return "".join(out)

    def batch_encode(self, texts):
        return [self.encode(t) for t in texts]

    def batch_encode_plus(self, texts):
        return {"input_ids": self.batch_encode(texts)}

    def __call__(self, text):
        if isinstance(text, str):
            return {"input_ids": self.encode(text)}
        return self.batch_encode_plus(text)


def get_tokenizer(language_model_name: str = "gpt2",
                  tokenizer_path: Optional[str] = None):
    """Resolve a tokenizer like the reference's ``get_tokenizer``, but
    network-optional.

    Order: explicit local path → HF hub via transformers → byte fallback.
    """
    if tokenizer_path is not None:
        return GPT2Tokenizer.from_dir(tokenizer_path)
    env = os.environ.get("CLIPCAP_TOKENIZER_PATH")
    if env and os.path.isdir(env):
        return GPT2Tokenizer.from_dir(env)
    try:
        from transformers import AutoTokenizer

        return AutoTokenizer.from_pretrained(language_model_name)
    except Exception:
        return ByteTokenizer()
