"""Shared averaged-perceptron core (Collins 2002) for the SPICE POS tagger
(``eval/postag.py``) and arc-standard dependency parser
(``eval/depparse.py``): sparse string features, one weight vector per
class, lazy averaging via (total, timestamp) accumulators, weights rounded
to 6 decimals at averaging so serialized models reproduce bit-for-bit.

One implementation for both models — a change to the averaging or pruning
math lands in exactly one place (review r5)."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple


class AveragedPerceptron:
    """Weight store + update/averaging machinery.  Subclasses own their
    class inventory, feature extraction, and training loop; they call
    ``_score`` to rank classes, ``_upd`` on mistakes (bumping ``self._i``
    once per instance themselves), and ``_average`` once after training."""

    def __init__(self) -> None:
        self.weights: Dict[str, Dict[str, float]] = {}
        # lazy-averaging accumulators (cleared by _average)
        self._totals: Dict[Tuple[str, str], float] = defaultdict(float)
        self._tstamps: Dict[Tuple[str, str], int] = defaultdict(int)
        self._i = 0

    def _score(self, feats: Sequence[str]) -> Dict[str, float]:
        scores: Dict[str, float] = defaultdict(float)
        for f in feats:
            ws = self.weights.get(f)
            if ws:
                for cls, w in ws.items():
                    scores[cls] += w
        return scores

    def _upd(self, cls: str, f: str, v: float) -> None:
        key = (f, cls)
        w = self.weights.setdefault(f, {})
        self._totals[key] += (self._i - self._tstamps[key]) * w.get(cls, 0.0)
        self._tstamps[key] = self._i
        w[cls] = w.get(cls, 0.0) + v

    def _average(self) -> None:
        for f, ws in self.weights.items():
            for cls in list(ws):
                key = (f, cls)
                total = (self._totals[key]
                         + (self._i - self._tstamps[key]) * ws[cls])
                avg = total / max(1, self._i)
                if abs(avg) > 1e-12:
                    ws[cls] = round(avg, 6)
                else:
                    del ws[cls]
        self._totals.clear()
        self._tstamps.clear()
