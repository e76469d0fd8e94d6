"""Corpus BLEU-1..4 for caption evaluation.

Fresh implementation of the algorithm the reference vendors
(ClipCap's clipcap/eval/pycocoevalcap/bleu/ — Papineni et al. 2002
corpus BLEU with the 'closest' reference-length option, per-image scores
computed with the same tiny/small smoothing constants so values are
numerically identical to coco-caption's).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Tuple

_TINY = 1e-15
_SMALL = 1e-9


def _ngrams(tokens: List[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


class Bleu:
    """Interface parity with coco-caption's ``Bleu``:
    ``compute_score(gts, res) -> (scores[4], per_image[4][N])``."""

    def __init__(self, n: int = 4):
        self.n = n

    def method(self) -> str:
        return "Bleu"

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[List[float], List[List[float]]]:
        keys = list(gts.keys())
        n = self.n

        total_correct = [0] * n
        total_guess = [0] * n
        total_clen = 0
        total_rlen = 0
        per_image: List[List[float]] = [[] for _ in range(n)]

        for key in keys:
            hyp = res[key][0].split()
            refs = [r.split() for r in gts[key]]
            clen = len(hyp)

            # 'closest' reference length (ties → shorter), as in bleu.py:46.
            rlen = min((abs(len(r) - clen), len(r)) for r in refs)[1]

            correct, guess = [], []
            for k in range(1, n + 1):
                hyp_ngrams = _ngrams(hyp, k)
                max_ref = Counter()
                for r in refs:
                    for gram, cnt in _ngrams(r, k).items():
                        max_ref[gram] = max(max_ref[gram], cnt)
                c = sum(min(cnt, max_ref[gram]) for gram, cnt in hyp_ngrams.items())
                g = max(0, clen - k + 1)
                correct.append(c)
                guess.append(g)
                total_correct[k - 1] += c
                total_guess[k - 1] += g

            total_clen += clen
            total_rlen += rlen

            # Per-image score with coco's smoothing constants.
            ratio = clen / (rlen + _SMALL)
            bp = 1.0 if ratio >= 1.0 else math.exp(1.0 - 1.0 / (ratio + _TINY))
            logp_sum = 0.0
            for k in range(n):
                p = (correct[k] + _TINY) / (guess[k] + _SMALL)
                logp_sum += math.log(p)
                per_image[k].append(bp * math.exp(logp_sum / (k + 1)))

        ratio = total_clen / (total_rlen + _SMALL)
        bp = 1.0 if ratio >= 1.0 else math.exp(1.0 - 1.0 / (ratio + _TINY))
        scores: List[float] = []
        logp_sum = 0.0
        for k in range(n):
            p = (total_correct[k] + _TINY) / (total_guess[k] + _SMALL)
            logp_sum += math.log(p)
            scores.append(bp * math.exp(logp_sum / (k + 1)))
        return scores, per_image
