"""Dependency parse -> SPICE semantic tuples.

The rule layer between the arc-standard parser (``eval/depparse.py``) and
the SPICE F-score harness (``eval/spice.py``): the native equivalent of the
Stanford scene-graph rules the reference runs inside ``spice-1.0.jar``
(ClipCap's clipcap/eval/pycocoevalcap/spice/spice.py:60-72),
implementing the gold-corpus conventions (Anderson et al. 2016 semantics,
documented in tests/test_eval.py + tests/test_spice_coco*.py):

* objects = head nouns; attributes from ``amod``/``compound``/``nummod``
  children, copular adjective predicates, and attributive participles;
* relations from noun-attached PPs (``nmod`` + ``case``), from verbs
  (subject, verb, object) with the verb absorbing a directly-attached
  ``obl`` preposition, and from copular PP predicates (NOT absorbed:
  "a man is ON a motorcycle" -> (man, on, motorcycle));
* conjunction groups distribute subjects, objects and attributes;
* pronouns are never resolved: a pronoun subject suppresses the relation,
  possessive pronouns vanish, ``'s`` possessives become a "have" relation;
* raising / light verbs ("seems to be", "getting ready to") contribute no
  tuple of their own; contentful control verbs keep a 2-tuple on the
  subject ("preparing to blow out her candle" -> (girl, preparing));
* adverbs, particles, determiners and depictive post-verbal adjectives
  (annotated ``advmod``) are dropped.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

Tuples = Set[Tuple[str, ...]]

NOUN_TAGS = {"NN", "NNS", "NNP", "NNPS"}
VERB_TAGS = {"VB", "VBD", "VBG", "VBN", "VBZ", "VBP"}
ADJ_TAGS = {"JJ", "JJR", "JJS"}
PRON_TAGS = {"PRP", "PRP$", "WDT", "WP", "EX"}

# Raising / light verbs: with an xcomp they contribute no tuple themselves.
RAISING = {"seems", "seem", "seemed", "appears", "appear", "appeared",
           "getting", "gets", "get", "got", "begins", "beginning", "began",
           "starts", "starting", "started", "continues", "continuing",
           "going", "goes", "went", "looks", "look", "looked"}

COPULAS = {"is", "are", "was", "were", "be", "been", "being", "am"}

# All words allowed to act as relation-labeling prepositions.
from clipcap_tpu_torch.eval.postag import CLOSED as _CLOSED

PREP_WORDS = {w for w, t in _CLOSED.items() if t == "IN"} | {
    "up", "down", "off", "out"}

# Spatial prepositions whose PP, when attached to the content noun of an
# of-chain, locates the CONTAINER (gold-corpus convention).
LOCATIVE_PREPS = {"on", "in", "at", "near", "beside", "by", "atop", "upon",
                  "over", "above", "under", "underneath", "below", "behind",
                  "against", "along", "inside", "outside", "across",
                  "between", "among", "around", "beneath", "on top of",
                  "in front of", "next to", "close to"}


class Parse:
    """0-indexed view of one parsed sentence."""

    def __init__(self, words: Sequence[str], tags: Sequence[str],
                 heads: Sequence[int], labels: Sequence[str]) -> None:
        self.words = list(words)
        self.tags = list(tags)
        # heads arrive 1-indexed (0=root): convert to 0-indexed, -1=root
        self.heads = [h - 1 for h in heads]
        self.labels = list(labels)
        n = len(self.words)
        self.children: List[List[int]] = [[] for _ in range(n)]
        for i, h in enumerate(self.heads):
            if h >= 0:
                self.children[h].append(i)

    def kids(self, i: int, label: str) -> List[int]:
        return [j for j in self.children[i] if self.labels[j] == label]

    def kid(self, i: int, label: str) -> Optional[int]:
        ks = self.kids(i, label)
        return ks[0] if ks else None

    def is_noun(self, i: int) -> bool:
        return self.tags[i] in NOUN_TAGS

    def is_verb(self, i: int) -> bool:
        return self.tags[i] in VERB_TAGS

    def is_adj(self, i: int) -> bool:
        return self.tags[i] in ADJ_TAGS

    def is_pron(self, i: int) -> bool:
        return self.tags[i] in PRON_TAGS

    def case_of(self, i: int) -> Optional[str]:
        k = self.kid(i, "case")
        if k is None or self.tags[k] == "POS":
            return None
        w = self.words[k]
        # only known prepositions may label relations: an OOV word the
        # parser mislabeled `case` must not fabricate one
        return w if w in PREP_WORDS else None

    def conj_group(self, i: int) -> List[int]:
        """i plus all transitive ``conj`` descendants (same-constituent
        coordination; first conjunct is the head)."""
        out = [i]
        stack = [i]
        while stack:
            j = stack.pop()
            for k in self.kids(j, "conj"):
                out.append(k)
                stack.append(k)
        return out

    def conj_root(self, i: int) -> int:
        j = i
        while self.labels[j] == "conj" and self.heads[j] >= 0:
            j = self.heads[j]
        return j


def _lift_subject_noun(p: Parse, h: int, _depth: int) -> Optional[int]:
    """Resolve the clause subject when a predicate attaches to noun ``h``:
    verbs act for the clause subject, so lift through object/oblique/PP
    chains ("a man in a jacket RIDING a bicycle" -> man; "a woman wearing
    a net CUTTING a cake" -> woman) — but NOT through "of" chains, whose
    content noun acts ("a group of people STANDING" -> people)."""
    seen = set()
    while h not in seen:
        seen.add(h)
        lab = p.labels[h]
        hd = p.heads[h]
        if hd < 0:
            break
        if lab in ("obj", "obl") and (p.is_verb(hd) or p.is_adj(hd)):
            return _subject_of(p, hd, _depth + 1)
        if lab == "nmod" and p.is_noun(hd) and p.case_of(h) != "of":
            h = hd
            continue
        if lab == "conj" and p.is_noun(hd):
            h = hd
            continue
        break
    return h


def _descend_of(p: Parse, s: int) -> int:
    """The content noun of an of-chain acts ("a herd of sheep grazing" ->
    sheep graze); descend at most one chain hop per level."""
    seen = set()
    while s not in seen:
        seen.add(s)
        nxt = None
        for j in p.kids(s, "nmod"):
            if p.case_of(j) == "of" and p.is_noun(j) and not p.is_pron(j):
                nxt = j
                break
        if nxt is None:
            return s
        s = nxt
    return s


def _subject_of(p: Parse, v: int, _depth: int = 0,
                descend: bool = True) -> Optional[int]:
    """Semantic subject (a noun index) of predicate ``v``; None if the
    subject is a pronoun or absent.  Relative pronouns resolve to the
    relativized noun; acting-verb subjects descend of-chains (content noun
    acts) unless ``descend`` is False (locative copular predicates, where
    the container locates: "a bowl of soup that is ON the counter")."""
    if _depth > 12:
        return None

    def fin(s: Optional[int]) -> Optional[int]:
        if s is None:
            return None
        if descend:
            return _descend_of(p, s)
        # containers locate: a locative predicate whose subject resolved to
        # the CONTENT noun of an of-chain belongs to the container ("a bowl
        # of soup that is ON the counter" -> bowl), wherever the parser
        # attached the relative clause
        seen = set()
        while (s not in seen and p.labels[s] == "nmod"
               and p.case_of(s) == "of" and p.heads[s] >= 0
               and p.is_noun(p.heads[s])):
            seen.add(s)
            s = p.heads[s]
        return s

    ns = p.kid(v, "nsubj")
    if ns is not None:
        if p.tags[ns] in ("WDT", "WP"):
            # relative pronoun: subject is the noun the clause modifies;
            # climb xcomp/conj to the clause root carrying the relcl label
            j = v
            while p.labels[j] in ("xcomp", "conj") and p.heads[j] >= 0:
                j = p.heads[j]
            if p.labels[j] == "relcl" and p.heads[j] >= 0:
                return fin(p.heads[j])
            return None
        if p.is_pron(ns):
            return None
        return fin(ns)
    lab = p.labels[v]
    h = p.heads[v]
    if h < 0:
        return None
    if lab in ("acl", "relcl") and p.is_noun(h):
        return fin(_lift_subject_noun(p, h, _depth))
    if lab in ("xcomp", "advcl"):
        # control verbs share their subject; bare adverbial clauses
        # inherit the matrix subject
        return _subject_of(p, h, _depth + 1, descend)
    if lab == "conj":
        if p.is_noun(h):  # VP conj the parser hung off an object noun
            return fin(_lift_subject_noun(p, h, _depth))
        return _subject_of(p, h, _depth + 1, descend)
    if lab == "nmod" and p.is_noun(h):
        # gerund after a preposition ("with the intent OF BLOWING out a
        # candle"): the clause subject acts
        return fin(_lift_subject_noun(p, h, _depth))
    return None


def _noun_groups(p: Parse, i: int) -> List[int]:
    return [j for j in p.conj_group(i) if p.is_noun(j)]


def tuples_from_parse(words: Sequence[str], tags: Sequence[str],
                      heads: Sequence[int], labels: Sequence[str]) -> Tuples:
    p = Parse(words, tags, heads, labels)
    out: Tuples = set()
    n = len(p.words)

    def w(i: int) -> str:
        return p.words[i]

    # ---- nouns: objects, attributes, nmod relations, possessives ----------
    for i in range(n):
        if not p.is_noun(i):
            continue
        if p.labels[i] == "compound":
            continue  # compound modifiers are attributes, not objects
        out.add((w(i),))
        for j in p.children[i]:
            lab = p.labels[j]
            if lab == "amod" and (p.is_adj(j) or p.tags[j] in ("VBN", "VBG")):
                for k in p.conj_group(j):
                    if p.is_adj(k) or p.tags[k] in ("VBN", "VBG"):
                        out.add((w(i), w(k)))
            elif lab == "compound" and (p.is_noun(j) or p.is_adj(j)):
                out.add((w(i), w(j)))
            elif lab == "nummod" and p.tags[j] == "CD":
                out.add((w(i), w(j)))
            elif lab == "nmod":
                c = p.case_of(j)
                if c is None or p.is_pron(j):
                    continue
                # containers locate: a LOCATIVE PP on the content noun of
                # an of-chain belongs to the container ("a bowl of soup ON
                # the counter" -> bowl on counter); of-chains themselves
                # keep nearest attachment ("the wheel OF a bicycle")
                host = i
                if (c in LOCATIVE_PREPS and p.labels[i] == "nmod"
                        and p.case_of(i) == "of" and p.heads[i] >= 0
                        and p.is_noun(p.heads[i])):
                    host = p.heads[i]
                # A TRAILING shared PP distributes over the host's
                # coordination group ("rows of palm trees and a bench ON
                # THE BEACH" locates rows AND bench) — but each conjunct's
                # PRIVATE PP stays its own ("a man WITH A HAT and a woman
                # WITH AN UMBRELLA" must not cross-relate): distribute
                # only when no OTHER conjunct carries a cased nmod of its
                # own.
                group = [m for m in p.conj_group(p.conj_root(host))
                         if p.is_noun(m) and not p.is_pron(m)]
                # (of-chains are part of the NP, not private PPs — they
                # never block distribution: "a bowl OF FRUIT and a vase
                # on a table" still locates both)
                others_have_pp = any(
                    m != host and any(p.case_of(k) not in (None, "of")
                                      for k in p.kids(m, "nmod"))
                    for m in group)
                # of-chains are private to their container in the other
                # direction too: "rows OF TREES and a bench" must not
                # yield (bench, of, trees)
                hosts = [host] if (others_have_pp or c == "of") else group
                for hh in hosts:
                    for b in _noun_groups(p, j):
                        out.add((w(hh), c, w(b)))
            elif lab == "poss":
                # only true 's possessives relate; a mislabeled bare noun
                # must not fabricate a "have"
                if p.is_noun(j) and any(p.tags[k] == "POS"
                                        for k in p.kids(j, "case")):
                    out.add((w(j), "have", w(i)))
        # postnominal adjective carrying an of-PP lifts it to the noun:
        # "a vase full of flowers" -> (vase, full) + (vase, of, flowers)
        for j in p.kids(i, "amod"):
            for k in p.kids(j, "nmod") + p.kids(j, "obl"):
                c = p.case_of(k)
                if c is not None and p.is_noun(k):
                    for b in _noun_groups(p, k):
                        out.add((w(i), c, w(b)))

    # ---- verbs and copular predicates --------------------------------------
    for v in range(n):
        is_cop_pred = (p.kid(v, "cop") is not None
                       and (p.is_adj(v) or p.is_noun(v)))
        if not (p.is_verb(v) or is_cop_pred):
            continue
        if p.labels[v] in ("amod", "aux", "cop", "case", "mark", "prt"):
            continue
        if p.is_verb(v) and p.kid(v, "expl") is not None:
            continue  # existential "there is"

        # locative copular predicates locate the CONTAINER of an of-chain
        # subject, not its content noun
        no_descend = (is_cop_pred and p.is_noun(v)
                      and p.case_of(v) in LOCATIVE_PREPS)
        subj = _subject_of(p, v, descend=not no_descend)
        subj_group = _noun_groups(p, subj) if subj is not None else []

        if is_cop_pred:
            if not subj_group:
                continue
            if p.is_adj(v):
                # adjective predicate (+ its adjective conjuncts) -> attributes
                for s in subj_group:
                    for k in p.conj_group(v):
                        if p.is_adj(k):
                            out.add((w(s), w(k)))
                # verb conjuncts off the predicate are handled as verbs
            else:
                # nominal predicate: PP predicate -> relation (not absorbed)
                c = p.case_of(v)
                if c is not None:
                    for s in subj_group:
                        for b in _noun_groups(p, v):
                            out.add((w(s), c, w(b)))
            continue

        word = w(v)
        xcomps = p.kids(v, "xcomp")
        # pronoun arguments never enter tuples; filtering them HERE keeps
        # the intransitive fallback live ("two men facing each other" ->
        # (men, facing)), matching the oblique-pronoun convention
        objs = [j for j in p.kids(v, "obj")
                if p.is_noun(j) and not p.is_pron(j)]
        obls = [j for j in p.kids(v, "obl")
                if p.is_noun(j) and not p.is_pron(j)]

        if word in COPULAS:
            continue  # bare auxiliary that slipped through
        if xcomps and word in RAISING:
            # raising/light verb: the xcomp carries the meaning — but an
            # ADJECTIVE xcomp would otherwise vanish ("the dog looks
            # HAPPY"), so emit it as a subject attribute first
            if subj_group:
                for j in xcomps:
                    if p.is_adj(j):
                        for k in p.conj_group(j):
                            if p.is_adj(k):
                                for s in subj_group:
                                    out.add((w(s), w(k)))
            continue
        emitted = False
        if subj_group:
            for j in objs:
                for s in subj_group:
                    for b in _noun_groups(p, j):
                        out.add((w(s), word, w(b)))
                        emitted = True
            for j in obls:
                # nearest-NP convention: a PP that follows the object
                # belongs to the object ("swinging a bat AT A BALL" ->
                # (bat, at, ball)), even when the parser attached it to
                # the verb as an oblique; without an object the verb
                # absorbs it ("grazing IN A FIELD" -> (sheep, grazing,
                # field))
                c = p.case_of(j)
                pre_objs = [o for o in objs if o < j]
                if c is not None and pre_objs:
                    host = max(pre_objs)
                    for a in _noun_groups(p, host):
                        for b in _noun_groups(p, j):
                            out.add((w(a), c, w(b)))
                    emitted = True
                    continue
                for s in subj_group:
                    for b in _noun_groups(p, j):
                        out.add((w(s), word, w(b)))
                        emitted = True
            if xcomps:
                # contentful control verb keeps a 2-tuple on the subject
                for s in subj_group:
                    out.add((w(s), word))
                emitted = True

        # depictive JJ advmod heading a PP ("flying a kite HIGH IN THE
        # SKY", "rising HIGH ABOVE the buildings"): the adjective itself
        # is dropped and its PP re-attaches per the nearest-NP convention
        # — to the preceding object if there is one, else absorbed by the
        # verb
        for j in p.kids(v, "advmod"):
            if not p.is_adj(j):
                continue
            for k in p.kids(j, "obl") + p.kids(j, "nmod"):
                c = p.case_of(k)
                if c is None or not p.is_noun(k) or p.is_pron(k):
                    continue
                pre_objs = [o for o in objs if o < j]
                if pre_objs:
                    host = max(pre_objs)
                    for a in _noun_groups(p, host):
                        for b in _noun_groups(p, k):
                            out.add((w(a), c, w(b)))
                elif subj_group:
                    for s in subj_group:
                        for b in _noun_groups(p, k):
                            out.add((w(s), word, w(b)))
                    emitted = True

        if subj_group and not emitted and not objs and not obls:
            # intransitive (incl. pronoun-obl "next to each other")
            for s in subj_group:
                out.add((w(s), word))

        # adjective xcomp of a verb: attribute of the subject
        # ("getting ready", "painted baby blue")
        for j in xcomps:
            if p.is_adj(j) and subj_group:
                for s in subj_group:
                    out.add((w(s), w(j)))

    return out
