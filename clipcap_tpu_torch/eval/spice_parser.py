"""Parser-backed SPICE tuple extraction.

Pipeline: PTB tokens -> multiword-preposition collapse -> POS tagging
(``eval/postag.py``) -> arc-standard dependency parse
(``eval/depparse.py``) -> scene-graph rules (``eval/scene_graph.py``).
This is the native replacement for the CoreNLP parse + scene-graph rules
inside the reference's ``spice-1.0.jar``
(ClipCap's clipcap/eval/pycocoevalcap/spice/spice.py:60-72).

Models train once per process from the committed caption treebank
(deterministic seed) and are memoized; a gzip JSON cache keyed by the
treebank digest makes subsequent processes load in milliseconds.  The
packaged cache (``data/spice_model_cache.json.gz``) is read and never
written; a retrain goes to this package's own user cache
(``~/.cache/clipcap_tpu_torch/spice_model_cache.json.gz``), not the JAX
package's.  ``CLIPCAP_SPICE_MODEL_CACHE`` names the one file read and
written instead (an unwritable path forces a retrain in every process).
"""
from __future__ import annotations

import gzip
import hashlib
import json
import os
import threading
import zlib
from typing import List, Optional, Sequence, Set, Tuple

from clipcap_tpu_torch.eval.depparse import ArcStandardParser, read_treebank
from clipcap_tpu_torch.eval.postag import PerceptronTagger
from clipcap_tpu_torch.eval.scene_graph import tuples_from_parse
# Shared with the chunker extractor so both see identical tokens (the
# multiword nmod labels CoreNLP emits).  spice.py imports THIS module only
# lazily, so there is no cycle.
from clipcap_tpu_torch.eval.spice import collapse_multiword

Tuples = Set[Tuple[str, ...]]

_DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
TREEBANK_PATH = os.path.join(_DATA_DIR, "caption_treebank.txt")

_lock = threading.Lock()
_models: Optional[Tuple[PerceptronTagger, ArcStandardParser]] = None

TAGGER_EPOCHS = 10
PARSER_EPOCHS = 14
SEED = 1


def _packaged_cache() -> str:
    return os.path.join(_DATA_DIR, "spice_model_cache.json.gz")


def _write_path() -> str:
    """Where retrained models are cached: ``$CLIPCAP_SPICE_MODEL_CACHE``,
    else this package's user cache.  Never the package's data directory
    (one user's retrain would replace the shipped cache for every user),
    never the JAX package's cache."""
    return os.environ.get("CLIPCAP_SPICE_MODEL_CACHE") or os.path.expanduser(
        "~/.cache/clipcap_tpu_torch/spice_model_cache.json.gz")


def _cache_paths() -> List[str]:
    """Cache files read, in order: ``$CLIPCAP_SPICE_MODEL_CACHE`` alone when
    set; else the packaged copy beside the treebank, then the user cache."""
    if os.environ.get("CLIPCAP_SPICE_MODEL_CACHE"):
        return [_write_path()]
    return [_packaged_cache(), _write_path()]


def _treebank_digest() -> str:
    from clipcap_tpu_torch.eval.data.gen_treebank import build_lexicon

    h = hashlib.sha256()
    with open(TREEBANK_PATH, "rb") as fh:
        h.update(fh.read())
    h.update(json.dumps(sorted(build_lexicon().items())).encode())
    h.update(f"|tag{TAGGER_EPOCHS}|par{PARSER_EPOCHS}|s{SEED}|v1".encode())
    return h.hexdigest()


def _train() -> Tuple[PerceptronTagger, ArcStandardParser]:
    from clipcap_tpu_torch.eval.data.gen_treebank import build_lexicon

    trees = read_treebank(TREEBANK_PATH)
    tagger = PerceptronTagger()
    tagger.train([(t.words, t.tags) for t in trees],
                 epochs=TAGGER_EPOCHS, seed=SEED,
                 lexicon=build_lexicon())
    parser = ArcStandardParser()
    parser.train(trees, epochs=PARSER_EPOCHS, seed=SEED)
    return tagger, parser


def get_models() -> Tuple[PerceptronTagger, ArcStandardParser]:
    global _models
    if _models is not None:
        return _models
    with _lock:
        if _models is not None:
            return _models
        digest = _treebank_digest()
        paths = _cache_paths()
        for path in paths:
            if not os.path.exists(path):
                continue
            try:
                with gzip.open(path, "rt") as fh:
                    blob = json.load(fh)
                if blob.get("digest") == digest:
                    _models = (PerceptronTagger.from_dict(blob["tagger"]),
                               ArcStandardParser.from_dict(blob["parser"]))
                    return _models
            except (OSError, EOFError, zlib.error, ValueError, KeyError):
                # OSError/EOFError/zlib BadGzipFile: truncated or corrupt
                # cache (e.g. a crashed writer) — fall through to retrain
                # and overwrite rather than crashing every future process
                pass
        tagger, parser = _train()
        blob = json.dumps({"digest": digest, "tagger": tagger.to_dict(),
                           "parser": parser.to_dict()})
        path = _write_path()
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"  # unique: two concurrent
            # retrainers must not publish each other's half-written file
            with gzip.open(tmp, "wt") as fh:
                fh.write(blob)
            os.replace(tmp, path)
        except OSError:
            import warnings

            warnings.warn(
                f"SPICE parser models could not be cached at {path}; every "
                "process will retrain (~30 s). Point CLIPCAP_SPICE_MODEL_CACHE "
                "at a writable path.")
        _models = (tagger, parser)
        return _models


def parse_tokens(tokens: Sequence[str]
                 ) -> Tuple[List[str], List[str], List[int], List[str]]:
    """-> (words, tags, heads, labels); heads 1-indexed, 0=root."""
    tagger, parser = get_models()
    words = collapse_multiword([t for t in tokens if t])
    tags = tagger.tag(words)
    heads, labels = parser.parse(words, tags)
    return words, tags, heads, labels


def extract_tuples_parsed(tokens: Sequence[str]) -> Tuples:
    """Caption tokens -> semantic proposition tuples, via the dependency
    parser (same output contract as ``eval/spice.py::extract_tuples``)."""
    words, tags, heads, labels = parse_tokens(tokens)
    if not words:
        return set()
    return tuples_from_parse(words, tags, heads, labels)
