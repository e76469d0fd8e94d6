"""ctypes front-end for the C++ METEOR core (drop-in for
clipcap_tpu_torch.eval.meteor.Meteor; exact + Snowball-stem + synonym +
paraphrase matcher stages, jar function-word list).

The paraphrase table is the meteor ``paraphrase-en.gz`` the reference jar
reads (fetched by ``python -m clipcap_tpu_torch.init``); since the C++ core reads
plain text, a ``.txt`` sidecar is decompressed next to the ``.gz`` once.
The synonym table is the flat folded form materialized by
``clipcap_tpu_torch.eval.meteor._flat_synonyms_path`` from the jar's WordNet
resources; the function-word list is the jar's ``function/en.words``.
"""
from __future__ import annotations

import ctypes
import gzip
import os
import shutil
from typing import Dict, List, Optional, Sequence, Tuple

from clipcap_tpu_torch.native import load

_N_STATS = 7


def _plain_table_path(path: str) -> str:
    """Decompress a .gz table to a cached sidecar; pass .txt through."""
    if not path.endswith(".gz"):
        return path
    sidecar = path[:-3] + ".txt"
    if not os.path.exists(sidecar) or (
        os.path.getmtime(sidecar) < os.path.getmtime(path)
    ):
        tmp = sidecar + ".tmp"
        with gzip.open(path, "rb") as src, open(tmp, "wb") as dst:
            shutil.copyfileobj(src, dst)
        os.replace(tmp, sidecar)
    return sidecar


class Meteor:
    def __init__(self, paraphrase_path: Optional[str] = None,
                 function_words_path: Optional[str] = None,
                 synonyms_path: Optional[str] = None):
        self._lib = load()
        table = (
            _plain_table_path(paraphrase_path).encode()
            if paraphrase_path
            else None
        )
        self._handle = self._lib.ccn_meteor_new(
            table,
            function_words_path.encode() if function_words_path else None,
            synonyms_path.encode() if synonyms_path else None,
        )
        if not self._handle:
            raise RuntimeError(
                "native METEOR init failed (paraphrase table: "
                f"{paraphrase_path}, function words: {function_words_path}, "
                f"synonyms: {synonyms_path})"
            )

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.ccn_meteor_delete(handle)
            self._handle = None

    def method(self) -> str:
        return "METEOR"

    def _stats(self, hyp: str, ref: str) -> List[float]:
        buf = (ctypes.c_double * _N_STATS)()
        self._lib.ccn_meteor_stats(self._handle, hyp.encode("utf-8"),
                                   ref.encode("utf-8"), buf)
        return list(buf)

    def _score(self, stats: Sequence[float]) -> float:
        buf = (ctypes.c_double * _N_STATS)(*stats)
        return float(self._lib.ccn_meteor_score_from_stats(buf))

    def score_segment(self, hypothesis: str, references: Sequence[str]) -> float:
        return max((self._score(self._stats(hypothesis, r)) for r in references),
                   default=0.0)

    # Public sufficient-statistics interface, mirroring
    # clipcap_tpu_torch.eval.meteor.Meteor (used by the stdio protocol server).
    def segment_stats(self, hypothesis: str, reference: str) -> List[float]:
        return self._stats(hypothesis, reference)

    def score_from_stats(self, stats: Sequence[float]) -> float:
        return self._score(stats)

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        keys = list(gts.keys())
        per_image: List[float] = []
        agg = [0.0] * _N_STATS
        for key in keys:
            hyp = res[key][0]
            best_score, best_stats = 0.0, None
            for ref in gts[key]:
                st = self._stats(hyp, ref)
                sc = self._score(st)
                if best_stats is None or sc > best_score:
                    best_score, best_stats = sc, st
            per_image.append(best_score)
            agg = [a + b for a, b in zip(agg, best_stats)]
        return self._score(agg), per_image
