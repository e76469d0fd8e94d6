"""ROUGE-L for caption evaluation.

Fresh implementation of the LCS-based F-measure the reference vendors
(ClipCap's clipcap/eval/pycocoevalcap/rouge/rouge.py: max precision
and max recall over references, beta = 1.2).
"""
from __future__ import annotations

from typing import Dict, List, Tuple


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


class Rouge:
    BETA = 1.2

    def method(self) -> str:
        return "Rouge"

    def calc_score(self, candidate: List[str], refs: List[str]) -> float:
        hyp = candidate[0].split()
        prec, rec = [], []
        for ref in refs:
            r = ref.split()
            lcs = _lcs_len(hyp, r)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(r) if r else 0.0)
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            return ((1 + self.BETA ** 2) * p * r) / (r + self.BETA ** 2 * p)
        return 0.0

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        scores = [self.calc_score(res[key], gts[key]) for key in gts.keys()]
        return (sum(scores) / len(scores) if scores else 0.0), scores
