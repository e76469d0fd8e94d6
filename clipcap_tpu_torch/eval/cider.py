"""CIDEr for caption evaluation.

Fresh implementation of CIDEr (Vedantam et al. 2015) matching the math the
reference vendors (ClipCap's clipcap/eval/pycocoevalcap/cider/):
tf-idf n-gram vectors (n = 1..4), document frequency from the reference
sets, per-n cosine similarity with count clipping and a gaussian length
penalty (sigma = 6), averaged over references and n, scaled by 10.
"""
from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Tuple

import numpy as np


def _ngram_counts(sentence: str, n: int = 4) -> Counter:
    words = sentence.split()
    counts: Counter = Counter()
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i : i + k])] += 1
    return counts


class Cider:
    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def method(self) -> str:
        return "CIDEr"

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, np.ndarray]:
        keys = list(gts.keys())
        crefs = [[_ngram_counts(r, self.n) for r in gts[k]] for k in keys]
        ctest = [_ngram_counts(res[k][0], self.n) for k in keys]

        # Document frequency over reference *sets* (cider_scorer.py:100-109).
        df: Dict[tuple, float] = defaultdict(float)
        for refs in crefs:
            for gram in set(g for ref in refs for g in ref):
                df[gram] += 1

        n_images = len(keys)
        log_n = math.log(max(n_images, 1.0))

        def vectorize(counts: Counter):
            """Per-n tf-idf vectors, norms, and length (cider_scorer.py:111-133)."""
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for gram, term_freq in counts.items():
                idf = log_n - math.log(max(df[gram], 1.0))
                k = len(gram) - 1
                vec[k][gram] = float(term_freq) * idf
                norm[k] += vec[k][gram] ** 2
                if k == 0:
                    length += term_freq
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vec_h, norm_h, len_h, vec_r, norm_r, len_r):
            """Clipped cosine per n with gaussian length penalty
            (cider_scorer.py:135-149)."""
            delta = float(len_h - len_r)
            val = np.zeros(self.n)
            for k in range(self.n):
                for gram, vh in vec_h[k].items():
                    val[k] += min(vh, vec_r[k].get(gram, 0.0)) * vec_r[k].get(gram, 0.0)
                if norm_h[k] != 0 and norm_r[k] != 0:
                    val[k] /= norm_h[k] * norm_r[k]
                val[k] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
            return val

        scores = []
        for hyp, refs in zip(ctest, crefs):
            vec_h, norm_h, len_h = vectorize(hyp)
            acc = np.zeros(self.n)
            for ref in refs:
                vec_r, norm_r, len_r = vectorize(ref)
                acc += sim(vec_h, norm_h, len_h, vec_r, norm_r, len_r)
            score_avg = np.mean(acc / len(refs)) * 10.0
            scores.append(score_avg)

        arr = np.array(scores)
        return float(np.mean(arr)), arr
