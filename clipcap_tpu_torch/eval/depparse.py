"""Transition-based dependency parser for caption text (arc-standard).

The native replacement for the CoreNLP dependency parsing inside the
reference's ``spice-1.0.jar``
(ClipCap's clipcap/eval/pycocoevalcap/spice/spice.py:60-72): a
greedy arc-standard shift-reduce parser with labeled arcs and an averaged
perceptron over sparse configuration features (a compact subset of
Zhang & Nivre 2011), trained on the caption-domain treebank in
``eval/data/caption_treebank.txt``.  The POS front-end is
``eval/postag.py``; the scene-graph rules that consume the parses live in
``eval/scene_graph.py``.

Transition system (stack ``s``, buffer ``b``, artificial ROOT at index 0):

* ``SHIFT``         — push ``b0``
* ``LEFT(label)``   — add arc ``s0 -> s1``, pop ``s1``  (``s1`` != ROOT)
* ``RIGHT(label)``  — add arc ``s1 -> s0``, pop ``s0``

Training uses the static oracle (gold transitions; weight update on every
wrong prediction, then follow gold).  All trees in the treebank are
projective — asserted at load — so the oracle always has a valid move.
Determinism: fixed shuffle seed, lexicographic tie-breaks.
"""
from __future__ import annotations

import random

from clipcap_tpu_torch.eval.perceptron import AveragedPerceptron
from typing import Dict, Iterable, List, Sequence, Tuple

SHIFT = "S"
ROOT_WORD = "-ROOT-"
ROOT_TAG = "-RT-"
_NULL = "-N-"


class Tree:
    """One treebank sentence: 1-indexed tokens, heads[i] in 0..n."""

    __slots__ = ("words", "tags", "heads", "labels")

    def __init__(self, words: List[str], tags: List[str],
                 heads: List[int], labels: List[str]) -> None:
        self.words = words
        self.tags = tags
        self.heads = heads
        self.labels = labels

    def is_projective(self) -> bool:
        arcs = [(min(h, d + 1), max(h, d + 1))
                for d, h in enumerate(self.heads)]
        for (a1, b1) in arcs:
            for (a2, b2) in arcs:
                if a1 < a2 < b1 < b2:
                    return False
        return True


def read_treebank(path: str) -> List[Tree]:
    trees: List[Tree] = []
    words: List[str] = []
    tags: List[str] = []
    heads: List[int] = []
    labels: List[str] = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                if words:
                    trees.append(Tree(words, tags, heads, labels))
                    words, tags, heads, labels = [], [], [], []
                continue
            idx, word, tag, head, label = line.split("\t")
            assert int(idx) == len(words) + 1, (path, line)
            words.append(word)
            tags.append(tag)
            heads.append(int(head))
            labels.append(label)
    if words:
        trees.append(Tree(words, tags, heads, labels))
    for k, t in enumerate(trees):
        assert t.is_projective(), ("non-projective tree", k, t.words)
        assert sum(1 for h in t.heads if h == 0) == 1, ("root count", k, t.words)
    return trees


def _feats(words: Sequence[str], tags: Sequence[str], stack: Sequence[int],
           buf_i: int, n: int, heads: List[int], labels: List[str],
           lchild: List[int], rchild: List[int], nkids: List[int]
           ) -> List[str]:
    """Sparse features of the current configuration.  ``words``/``tags``
    are 0-indexed with the ROOT entry prepended at position 0."""

    def w(i: int) -> str:
        return words[i] if i >= 0 else _NULL

    def t(i: int) -> str:
        return tags[i] if i >= 0 else _NULL

    s0 = stack[-1] if len(stack) > 0 else -1
    s1 = stack[-2] if len(stack) > 1 else -1
    s2 = stack[-3] if len(stack) > 2 else -1
    b0 = buf_i if buf_i < n else -1
    b1 = buf_i + 1 if buf_i + 1 < n else -1
    b2 = buf_i + 2 if buf_i + 2 < n else -1

    s0w, s0t = w(s0), t(s0)
    s1w, s1t = w(s1), t(s1)
    b0w, b0t = w(b0), t(b0)

    def cl(i: int, arr: List[int], what: str) -> str:
        if i < 0 or arr[i] < 0:
            return _NULL
        j = arr[i]
        return tags[j] if what == "t" else labels[j - 1]

    s0lct, s0rct = cl(s0, lchild, "t"), cl(s0, rchild, "t")
    s1lct, s1rct = cl(s1, lchild, "t"), cl(s1, rchild, "t")
    s0lcl, s0rcl = cl(s0, lchild, "l"), cl(s0, rchild, "l")
    s1lcl, s1rcl = cl(s1, lchild, "l"), cl(s1, rchild, "l")
    dist = "0" if s1 < 0 else str(min(s0 - s1, 5))
    s0v = str(min(nkids[s0], 3)) if s0 >= 0 else _NULL
    s1v = str(min(nkids[s1], 3)) if s1 >= 0 else _NULL

    return [
        "b",
        "s0w=" + s0w, "s0t=" + s0t, "s0wt=" + s0w + "|" + s0t,
        "s1w=" + s1w, "s1t=" + s1t, "s1wt=" + s1w + "|" + s1t,
        "s2t=" + t(s2),
        "b0w=" + b0w, "b0t=" + b0t, "b0wt=" + b0w + "|" + b0t,
        "b1w=" + w(b1), "b1t=" + t(b1), "b2t=" + t(b2),
        "s0t|s1t=" + s0t + "|" + s1t,
        "s0w|s1w=" + s0w + "|" + s1w,
        "s0t|s1w=" + s0t + "|" + s1w,
        "s0w|s1t=" + s0w + "|" + s1t,
        "s0t|b0t=" + s0t + "|" + b0t,
        "s1t|b0t=" + s1t + "|" + b0t,
        "s0w|b0t=" + s0w + "|" + b0t,
        "s0t|b0w=" + s0t + "|" + b0w,
        "s1w|b0t=" + s1w + "|" + b0t,
        "s0t|s1t|b0t=" + s0t + "|" + s1t + "|" + b0t,
        "s1t|s0t|s0lct=" + s1t + "|" + s0t + "|" + s0lct,
        "s1t|s0t|s0rct=" + s1t + "|" + s0t + "|" + s0rct,
        "s0t|s1t|s1lct=" + s0t + "|" + s1t + "|" + s1lct,
        "s0t|s1t|s1rct=" + s0t + "|" + s1t + "|" + s1rct,
        "s0lcl=" + s0lcl, "s0rcl=" + s0rcl,
        "s1lcl=" + s1lcl, "s1rcl=" + s1rcl,
        "s1w|s1rcl=" + s1w + "|" + s1rcl,
        "s0w|s0lcl=" + s0w + "|" + s0lcl,
        "dist=" + dist,
        "s0t|s1t|d=" + s0t + "|" + s1t + "|" + dist,
        "s0v=" + s0v, "s1v=" + s1v,
        "s1t|s1v=" + s1t + "|" + s1v,
    ]


class ArcStandardParser(AveragedPerceptron):
    def __init__(self) -> None:
        super().__init__()
        self.actions: List[str] = []

    @staticmethod
    def _valid(action: str, stack: List[int], buf_i: int, n: int) -> bool:
        if action == SHIFT:
            return buf_i < n
        if action.startswith("L|"):
            return len(stack) >= 2 and stack[-2] != 0
        # RIGHT: root arc only allowed onto ROOT when buffer is consumed
        if len(stack) < 2:
            return False
        if stack[-2] == 0:
            return buf_i >= n and len(stack) == 2 and action == "R|root"
        return action != "R|root"

    # -- parsing ------------------------------------------------------------

    def parse(self, words_in: Sequence[str], tags_in: Sequence[str]
              ) -> Tuple[List[int], List[str]]:
        """Greedy parse; returns (heads, labels), 1-indexed heads, 0=root."""
        n_tok = len(words_in)
        if n_tok == 0:
            return [], []
        words = [ROOT_WORD] + list(words_in)
        tags = [ROOT_TAG] + list(tags_in)
        n = n_tok + 1
        heads = [-1] * n
        labels: List[str] = [""] * max(0, n_tok)
        lchild = [-1] * n
        rchild = [-1] * n
        nkids = [0] * n
        stack = [0]
        buf_i = 1
        steps = 0
        while not (buf_i >= n and len(stack) == 1):
            steps += 1
            if steps > 4 * n + 8:  # safety: cannot loop given _valid, but bound anyway
                break
            feats = _feats(words, tags, stack, buf_i, n, heads, labels,
                           lchild, rchild, nkids)
            scores = self._score(feats)
            act = max(
                (a for a in self.actions if self._valid(a, stack, buf_i, n)),
                key=lambda a: (scores.get(a, 0.0), a),
                default=None,
            )
            if act is None:  # no valid action (empty model): bail to flat tree
                break
            buf_i, _ = self._apply(act, stack, buf_i, heads, labels,
                                   lchild, rchild, nkids)
        # any unattached tokens (broken parse) attach flat to ROOT
        for i in range(1, n):
            if heads[i] < 0:
                heads[i] = 0
                labels[i - 1] = labels[i - 1] or "dep"
        return heads[1:], labels

    @staticmethod
    def _apply(action: str, stack: List[int], buf_i: int, heads: List[int],
               labels: List[str], lchild: List[int], rchild: List[int],
               nkids: List[int]) -> Tuple[int, str]:
        if action == SHIFT:
            stack.append(buf_i)
            return buf_i + 1, action
        label = action[2:]
        if action.startswith("L|"):
            dep, head = stack[-2], stack[-1]
            stack.pop(-2)
        else:
            dep, head = stack[-1], stack[-2]
            stack.pop()
        heads[dep] = head
        labels[dep - 1] = label
        nkids[head] += 1
        if dep < head:
            if lchild[head] < 0 or dep < lchild[head]:
                lchild[head] = dep
        else:
            if rchild[head] < 0 or dep > rchild[head]:
                rchild[head] = dep
        return buf_i, action

    # -- oracle + training ----------------------------------------------------

    @staticmethod
    def _oracle(stack: List[int], buf_i: int, n: int, gold_heads: List[int],
                gold_labels: List[str], done_kids: List[int],
                gold_nkids: List[int]) -> str:
        if len(stack) >= 2:
            s0, s1 = stack[-1], stack[-2]
            if s1 != 0 and gold_heads[s1] == s0 and done_kids[s1] == gold_nkids[s1]:
                return "L|" + gold_labels[s1 - 1]
            if gold_heads[s0] == s1 and done_kids[s0] == gold_nkids[s0]:
                return "R|" + gold_labels[s0 - 1]
        assert buf_i < n, "oracle stuck (non-projective tree?)"
        return SHIFT

    def train(self, trees: Iterable[Tree], epochs: int = 8, seed: int = 1
              ) -> None:
        data = list(trees)
        acts = {SHIFT}
        for t in data:
            for l in t.labels:
                acts.add("L|" + l)
                acts.add("R|" + l)
        acts.discard("L|root")
        self.actions = sorted(acts)
        rng = random.Random(seed)
        for _ in range(epochs):
            rng.shuffle(data)
            for t in data:
                self._train_one(t)
        self._average()

    def _train_one(self, t: Tree) -> None:
        n = len(t.words) + 1
        words = [ROOT_WORD] + t.words
        tags = [ROOT_TAG] + t.tags
        gold_heads = [-1] + t.heads
        gold_labels = t.labels
        gold_nkids = [0] * n
        for h in t.heads:
            gold_nkids[h] += 1
        heads = [-1] * n
        labels = [""] * (n - 1)
        lchild = [-1] * n
        rchild = [-1] * n
        nkids = [0] * n
        done_kids = [0] * n
        stack = [0]
        buf_i = 1
        while not (buf_i >= n and len(stack) == 1):
            gold_act = self._oracle(stack, buf_i, n, gold_heads, gold_labels,
                                    done_kids, gold_nkids)
            self._i += 1
            feats = _feats(words, tags, stack, buf_i, n, heads, labels,
                           lchild, rchild, nkids)
            scores = self._score(feats)
            pred = max(
                (a for a in self.actions if self._valid(a, stack, buf_i, n)),
                key=lambda a: (scores.get(a, 0.0), a),
            )
            if pred != gold_act:
                for f in feats:
                    self._upd(gold_act, f, 1.0)
                    self._upd(pred, f, -1.0)
            if gold_act != SHIFT:
                dep = stack[-2] if gold_act.startswith("L|") else stack[-1]
                done_kids[gold_heads[dep]] += 1
            buf_i, _ = self._apply(gold_act, stack, buf_i, heads, labels,
                                   lchild, rchild, nkids)

    # -- (de)serialization ------------------------------------------------------

    def to_dict(self) -> Dict:
        return {"weights": self.weights, "actions": self.actions}

    @classmethod
    def from_dict(cls, d: Dict) -> "ArcStandardParser":
        p = cls()
        p.weights = {f: dict(ws) for f, ws in d["weights"].items()}
        p.actions = list(d["actions"])
        return p
