"""RoBERTa tokenization for the CLAP text tower (laion_clap tokenizes
captions with RobertaTokenizer, max_length 77).

The port's own copy of ``clipcap_tpu/utils/roberta_tokenizer.py``: the
same ids.  Resolution order, network-free:
1. a local vocab/merges dir via ``CLIPCAP_ROBERTA_TOKENIZER`` (RoBERTa's
   vocab.json/merges.txt use GPT-2's byte-level BPE format, so the port's
   own BPE engine drives them; only the special tokens differ, and the
   vocabulary must hold GPT-2's ``<|endoftext|>`` entry);
2. HF ``roberta-base`` through transformers, from its local cache only;
3. a hash fallback.  Python salts ``hash`` of a ``str`` per process
   (``PYTHONHASHSEED``), so its ids hold within one process only (ROADMAP
   C8, in both packages); an exact rerank needs 1 or 2.
"""
from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

BOS, PAD, EOS = 0, 1, 2
CONTEXT_LENGTH = 77

_resolved = None


def _resolve():
    global _resolved
    if _resolved is not None:
        return _resolved

    path = os.environ.get("CLIPCAP_ROBERTA_TOKENIZER")
    if path and os.path.isdir(path):
        from clipcap_tpu_torch.utils.tokenizer import GPT2Tokenizer

        tok = GPT2Tokenizer.from_files(
            os.path.join(path, "vocab.json"), os.path.join(path, "merges.txt"))
        _resolved = ("bpe", tok)
        return _resolved
    try:
        from transformers import RobertaTokenizer

        _resolved = ("hf", RobertaTokenizer.from_pretrained("roberta-base",
                                                            local_files_only=True))
        return _resolved
    except Exception:
        _resolved = ("hash", None)
        return _resolved


def roberta_tokenize(
    texts: Sequence[str],
    context_length: int = CONTEXT_LENGTH,
    vocab_size: int = 50265,
) -> Tuple[np.ndarray, np.ndarray]:
    """texts → (ids [B, L] int32, attention_mask [B, L] int32)."""
    kind, tok = _resolve()
    ids_batch: List[List[int]] = []
    for text in texts:
        if kind == "hf":
            ids = tok.encode(text, add_special_tokens=True)
        elif kind == "bpe":
            ids = [BOS] + tok.encode(" " + text.strip()) + [EOS]
        else:
            body = [4 + (hash(("clap", w)) % (vocab_size - 8))
                    for w in text.lower().split()]
            ids = [BOS] + body + [EOS]
        ids_batch.append(ids[:context_length])

    out = np.full((len(texts), context_length), PAD, np.int32)
    mask = np.zeros((len(texts), context_length), np.int32)
    for i, ids in enumerate(ids_batch):
        out[i, :len(ids)] = ids
        mask[i, :len(ids)] = 1
    return out, mask
