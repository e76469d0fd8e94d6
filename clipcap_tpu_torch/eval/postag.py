"""Averaged-perceptron part-of-speech tagger for caption text.

POS front-end for the SPICE dependency parser (``eval/depparse.py``),
replacing the closed-lexicon heuristics of the chunker extractor.  The
reference gets tagging implicitly through CoreNLP inside ``spice-1.0.jar``
(ClipCap's clipcap/eval/pycocoevalcap/spice/spice.py:60-72); this is
the native equivalent, trained on the caption-domain treebank in
``eval/data/caption_treebank.txt``.

Classic greedy averaged perceptron (Collins 2002): one weight vector per
tag over sparse string features of the local window plus the two previous
predicted tags.  Two constraint layers sit in front of the model:

* ``CLOSED`` — hand-pinned closed-class words (determiners, prepositions,
  pronouns, auxiliaries...) whose tag never depends on context in caption
  text;
* a learned unambiguous-word dictionary (words seen >= 4 times in training
  with a single tag) for fast, error-proof lookup.

Everything is deterministic: ties break lexicographically, training order
is fixed by the caller's seed.
"""
from __future__ import annotations

import random
from collections import defaultdict

from clipcap_tpu_torch.eval.perceptron import AveragedPerceptron
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# Tags follow the PTB tagset (the treebank uses a caption-relevant subset).
START = ("-S1-", "-S2-")

# Closed-class words whose caption-text tag is context-free.  Multiword
# prepositions arrive pre-collapsed into single tokens ("in front of").
CLOSED: Dict[str, str] = {}
for _w in ("a", "an", "the", "this", "that_det", "these", "those", "some",
           "any", "no", "each", "every", "both", "another"):
    CLOSED[_w] = "DT"
for _w in ("in", "on", "at", "by", "with", "near", "under", "over", "above",
           "below", "behind", "beside", "between", "among", "around",
           "inside", "outside", "against", "along", "across", "through",
           "onto", "into", "atop", "upon", "underneath", "of", "from",
           "off", "past", "beneath", "toward", "towards", "during",
           "throughout", "without", "beyond", "amongst", "amid",
           "in front of", "on top of", "next to", "close to", "as",
           "while", "because", "after", "before", "since", "than",
           "in between"):
    CLOSED[_w] = "IN"
for _w in ("he", "she", "it", "they", "him", "them", "i", "we", "us",
           "someone", "something", "anyone", "everyone", "other", "others",
           "one_pron"):
    CLOSED[_w] = "PRP"
for _w in ("his", "her", "its", "their", "my", "your", "our"):
    CLOSED[_w] = "PRP$"
for _w in ("and", "or", "but", "nor"):
    CLOSED[_w] = "CC"
for _w in ("who", "which", "whom", "whose"):
    CLOSED[_w] = "WDT"
CLOSED["there"] = "EX"
CLOSED["to"] = "TO"
CLOSED["'s"] = "POS"
CLOSED["not"] = "RB"
CLOSED["n't"] = "RB"
for _w in ("is", "are", "was", "were", "be", "been", "being", "am"):
    CLOSED[_w] = "VBZ" if _w == "is" else (
        "VBP" if _w in ("are", "am") else
        "VBD" if _w in ("was", "were") else
        "VB" if _w == "be" else "VBN" if _w == "been" else "VBG")
for _w in ("can", "could", "will", "would", "may", "might", "must",
           "shall", "should"):
    CLOSED[_w] = "MD"
for _w in ("two", "three", "four", "five", "six", "seven", "eight", "nine",
           "ten", "eleven", "twelve", "dozen", "couple_num"):
    CLOSED[_w] = "CD"
# quantifiers score as determiners, not numbers: SPICE keeps (birds, five)
# but drops (boats, several) — gold-corpus convention
for _w in ("several", "many", "few"):
    CLOSED[_w] = "DT"
# 'that' is ambiguous (DT/WDT/IN) and 'one' (CD/PRP) — left to the model;
# the _det/_pron/_num sentinel keys above are never real tokens.
for _k in ("that_det", "one_pron", "couple_num"):
    del CLOSED[_k]


def _shape(word: str) -> str:
    if word.isdigit():
        return "#d"
    if "-" in word:
        return "#h"
    return "#x"


def _features(words: Sequence[str], i: int, prev: str, prev2: str
              ) -> List[str]:
    w = words[i]
    wm1 = words[i - 1] if i > 0 else "-B1-"
    wm2 = words[i - 2] if i > 1 else "-B2-"
    wp1 = words[i + 1] if i + 1 < len(words) else "-E1-"
    wp2 = words[i + 2] if i + 2 < len(words) else "-E2-"
    return [
        "b",
        "w=" + w,
        "sf3=" + w[-3:],
        "sf2=" + w[-2:],
        "sf1=" + w[-1:],
        "pf1=" + w[:1],
        "sh=" + _shape(w),
        "t1=" + prev,
        "t2=" + prev2,
        "t12=" + prev + "+" + prev2,
        "wm1=" + wm1,
        "sm1=" + wm1[-3:],
        "wm2=" + wm2,
        "wp1=" + wp1,
        "sp1=" + wp1[-3:],
        "wp2=" + wp2,
        "t1w=" + prev + "+" + w,
        "wm1w=" + wm1 + "+" + w,
        "wwp1=" + w + "+" + wp1,
    ]


class PerceptronTagger(AveragedPerceptron):
    def __init__(self) -> None:
        super().__init__()
        self.classes: List[str] = []
        self.tagdict: Dict[str, str] = {}

    # -- prediction --------------------------------------------------------

    def _predict(self, feats: Sequence[str]) -> str:
        scores = self._score(feats)
        return max(self.classes, key=lambda c: (scores.get(c, 0.0), c))

    def tag(self, words: Sequence[str]) -> List[str]:
        prev, prev2 = START
        out: List[str] = []
        for i, w in enumerate(words):
            t = CLOSED.get(w) or self.tagdict.get(w)
            if t is None:
                t = self._predict(_features(words, i, prev, prev2))
            out.append(t)
            prev2, prev = prev, t
        return out

    # -- training ----------------------------------------------------------

    def train(self, sentences: Iterable[Tuple[Sequence[str], Sequence[str]]],
              epochs: int = 6, seed: int = 1,
              lexicon: Optional[Dict[str, str]] = None) -> None:
        sents = list(sentences)
        # unambiguous-word dictionary
        counts: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
        for words, tags in sents:
            for w, t in zip(words, tags):
                counts[w][t] += 1
        for w, tc in counts.items():
            total = sum(tc.values())
            t, n = max(tc.items(), key=lambda kv: (kv[1], kv[0]))
            if total >= 4 and n == total and w not in CLOSED:
                self.tagdict[w] = t
        # curated lexicon: pin words whose training occurrences (if any)
        # don't contradict it
        for w, t in (lexicon or {}).items():
            if w in CLOSED:
                continue
            tc = counts.get(w)
            if tc is None or (len(tc) == 1 and t in tc):
                self.tagdict[w] = t
        self.classes = sorted({t for _, tags in sents for t in tags})
        rng = random.Random(seed)
        # Train on EVERY token (pins apply only at inference): the model
        # must learn suffix/context priors from the full distribution to
        # handle unknown words and the genuinely ambiguous ones the
        # dictionaries leave to it ("stands", "watches", "painting").
        for _ in range(epochs):
            rng.shuffle(sents)
            for words, gold in sents:
                prev, prev2 = START
                for i, w in enumerate(words):
                    self._i += 1
                    feats = _features(words, i, prev, prev2)
                    t = self._predict(feats)
                    if t != gold[i]:
                        for f in feats:
                            self._upd(gold[i], f, 1.0)
                            self._upd(t, f, -1.0)
                    prev2, prev = prev, gold[i]  # gold history
        self._average()

    # -- (de)serialization --------------------------------------------------

    def to_dict(self) -> Dict:
        return {"weights": self.weights, "classes": self.classes,
                "tagdict": self.tagdict}

    @classmethod
    def from_dict(cls, d: Dict) -> "PerceptronTagger":
        t = cls()
        t.weights = {f: dict(ws) for f, ws in d["weights"].items()}
        t.classes = list(d["classes"])
        t.tagdict = dict(d["tagdict"])
        return t
