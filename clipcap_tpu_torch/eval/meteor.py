"""METEOR scorer — native re-implementation of the METEOR 1.5 algorithm.

The reference drives ``meteor-1.5.jar`` over a stdio line protocol with
``-l en -norm -a data/paraphrase-en.gz``
(ClipCap's clipcap/eval/pycocoevalcap/meteor/meteor.py:21-63).  This
module re-implements that scorer (Denkowski & Lavie 2011, 2014) in Python —
no JVM:

* **Normalization** (``-norm``): lowercase + punctuation split, applied to
  both hypothesis and references.
* **Matcher stages**: exact → stem → synonym → paraphrase.  The stem stage
  uses the Snowball English ("Porter2") stemmer — the same algorithm as the
  jar's ``org.tartarus.snowball.ext.englishStemmer``
  (clipcap_tpu_torch/eval/snowball.py, validated against nltk's independent
  implementation).  The synonym stage runs on the jar's WordNet tables when
  ``python -m clipcap_tpu_torch.init`` has fetched them, and otherwise on the
  SHIPPED compact curated table (``data/synonyms_en_compact.txt``) so the
  stage is live by default offline — measured corpus-level effect +0.0069
  METEOR on the committed COCO caption corpus (the full tier table lives in
  docs/performance.md, "METEOR resources"); ``CLIPCAP_METEOR_SYNONYMS=none``
  disables it.  The paraphrase stage activates when ``paraphrase-en.gz`` is
  present (also fetched by init).  Paraphrase matches are phrase-level: a
  match may cover multi-word spans on both sides, exactly like the jar's
  paraphrase matcher.
* **Alignment**: beam search over the candidate match set with the jar's
  objective — lexicographically maximize (total words covered,
  −chunks, −total start-position distance).  Verified against exhaustive
  search on small sentences in tests/test_eval.py.
* **Scoring**: METEOR 1.5 English defaults (the WMT-rank-tuned parameters
  the jar uses for ``-l en`` with no ``-t`` flag; Denkowski & Lavie 2011,
  Table 3): alpha=0.85, beta=0.2, gamma=0.6, delta=0.75, stage weights
  (1.0, 0.6, 0.8, 0.6).  Content/function-word weighted P and R, harmonic
  mean, fragmentation penalty ``gamma * (chunks / mean_matches) ** beta``,
  best reference per segment by score, corpus score from summed sufficient
  statistics (the jar's ``EVAL`` aggregation).

Resources (all of them the jar's own data, extracted from ``meteor-1.5.jar``
by ``python -m clipcap_tpu_torch.init`` into :data:`CACHE_DIR` — the jar is a
zip archive):

* ``function/en.words`` → the jar's corpus-derived function-word list
  (``default_function_words_path``); without it a hand-curated closed-class
  list is used (the only remaining divergence in that case).
* ``synonym/english.synsets`` + ``synonym/english.exceptions`` → the jar's
  WordNet-derived synonym data (``Synonyms.load``): two words match at the
  synonym stage iff their synset-id sets intersect, where each word's ids
  include those of its morphological base forms from the exceptions file.
* ``data/paraphrase-en.gz`` → the paraphrase table (also shipped standalone
  by coco-caption).

Segment scores are exact for the algorithm as published; with all three
resources present the known divergences vs the jar are closed (jar-bitwise
validation still requires a JVM, which this environment does not have).
"""
from __future__ import annotations

import gzip
import logging
import math
import os
import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

from clipcap_tpu_torch.eval.snowball import snowball_stem

# METEOR 1.5 English defaults (WMT rank-tuned; used by `-l en` with no -t).
ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
STAGE_WEIGHTS = (1.0, 0.6, 0.8, 0.6)  # exact, stem, synonym, paraphrase
BEAM_WIDTH = 40  # the jar's aligner beam size

# Compact English function-word list (the jar's function/en.words resource
# is corpus-derived; this covers the high-frequency closed classes).
FUNCTION_WORDS: Set[str] = set("""
a an the this that these those some any each every no
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself ourselves themselves
am is are was were be been being do does did doing have has had having
will would shall should may might must can could ought
and or but nor so yet for if while although though because since unless until when whenever
where wherever whether as than that which who whom whose what
in on at by with from into onto of to up down over under above below between among
through during before after about against along around behind beside besides beyond
despite except inside outside toward towards upon within without
not n't there here then now just only also very too quite rather
""".split())

# ASCII punctuation except apostrophe; non-ASCII passes through as word
# characters (keeps the C++ core byte-compatible on UTF-8 input).
_PUNCT_RE = re.compile(r"([!-&(-/:-@\[-`{-~])")

_STATS_KEYS = ("matches_h", "matches_r", "chunks",
               "w_matched_h", "w_matched_r", "w_len_h", "w_len_r")


def normalize(text: str) -> List[str]:
    """`-norm`-style preprocessing: lowercase + split punctuation into
    separate tokens (inputs in the coco pipeline are already PTB-tokenized
    and lowercased, so this is usually the identity past lowercasing)."""
    text = text.lower()
    text = _PUNCT_RE.sub(r" \1 ", text)
    return text.split()


def load_paraphrase_table(path: str) -> Dict[str, Set[str]]:
    """Load a paraphrase table in the meteor ``paraphrase-en.gz`` line format
    (``phrase ||| paraphrase`` lines, or tab-separated pairs)."""
    table: Dict[str, Set[str]] = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = [p.strip() for p in line.split("|||")]
            if len(parts) < 2:
                parts = [p.strip() for p in line.split("\t")]
            if len(parts) >= 2 and parts[0] and parts[1]:
                table.setdefault(parts[0], set()).add(parts[1])
    return table


# The port's own cache: init puts the jar's resources here and the scorer
# writes its flattened synonym table here (never the JAX package's cache).
CACHE_DIR = "~/.cache/clipcap_tpu_torch/meteor"


def _default_resource(env_var: str, cache_name: str) -> Optional[str]:
    env = os.environ.get(env_var)
    if env and os.path.exists(env):
        return env
    cached = os.path.expanduser(f"{CACHE_DIR}/{cache_name}")
    if os.path.exists(cached):
        return cached
    return None


def default_paraphrase_path() -> Optional[str]:
    """The paraphrase table fetched by ``python -m clipcap_tpu_torch.init``
    (or pointed at via $CLIPCAP_METEOR_PARAPHRASE)."""
    return _default_resource("CLIPCAP_METEOR_PARAPHRASE", "paraphrase-en.gz")


def default_function_words_path() -> Optional[str]:
    """The jar's ``function/en.words``, extracted by init
    (or $CLIPCAP_METEOR_FUNCTION_WORDS)."""
    return _default_resource("CLIPCAP_METEOR_FUNCTION_WORDS", "en.words")


def default_synonym_paths() -> Optional[Tuple[str, Optional[str]]]:
    """The jar's WordNet synonym resources, extracted by init:
    (synsets path, exceptions path or None).  Overridable with
    $CLIPCAP_METEOR_SYNONYMS (a synsets file; a sibling ``*.exceptions``
    is picked up automatically; the value ``none`` disables the synonym
    stage entirely, including the shipped compact table)."""
    if os.environ.get("CLIPCAP_METEOR_SYNONYMS", "").lower() == "none":
        return None
    syn = _default_resource("CLIPCAP_METEOR_SYNONYMS", "english.synsets")
    if syn is None:
        return None
    exc = os.path.join(os.path.dirname(syn), "english.exceptions")
    return syn, (exc if os.path.exists(exc) else None)


def compact_synonyms_path() -> str:
    """The shipped hand-curated synonym table (``data/
    synonyms_en_compact.txt``) — the offline default that keeps the synonym
    stage live when the init-fetched WordNet tables are absent.  The
    init-fetched tables take precedence (``default_synonym_paths``)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "data", "synonyms_en_compact.txt")


def load_function_words(path: str) -> Set[str]:
    """One word per line (``#`` comments and blanks skipped) — the format of
    the jar's ``function/en.words`` resource."""
    out: Set[str] = set()
    with open(path, "rt", encoding="utf-8", errors="replace") as f:
        for line in f:
            w = line.strip().lower()
            if w and not w.startswith("#"):
                out.add(w)
    return out


class Synonyms:
    """The jar's synonym-stage relation: word → WordNet synset-id set; two
    words are synonym-stage matches iff their id sets intersect.  The
    morphological exceptions file maps irregular surface forms to base
    forms whose synsets the surface form inherits (the jar's
    SynonymDictionary does the same two-file lookup)."""

    def __init__(self, word_ids: Dict[str, Set[int]]):
        self.word_ids = word_ids

    @classmethod
    def load(cls, synsets_path: str,
             exceptions_path: Optional[str] = None) -> "Synonyms":
        """``english.synsets`` lines: ``word id id ...``;
        ``english.exceptions`` lines: ``variant base base ...``."""
        word_ids: Dict[str, Set[int]] = {}
        with open(synsets_path, "rt", encoding="utf-8", errors="replace") as f:
            for line in f:
                parts = line.split()
                if len(parts) < 2:
                    continue
                ids = set()
                for p in parts[1:]:
                    try:
                        ids.add(int(p))
                    except ValueError:
                        pass
                if ids:
                    word_ids.setdefault(parts[0].lower(), set()).update(ids)
        if exceptions_path:
            with open(exceptions_path, "rt", encoding="utf-8",
                      errors="replace") as f:
                for line in f:
                    parts = [p.lower() for p in line.split()]
                    if len(parts) < 2:
                        continue
                    variant = parts[0]
                    inherited = set()
                    for base in parts[1:]:
                        inherited |= word_ids.get(base, set())
                    if inherited:
                        word_ids.setdefault(variant, set()).update(inherited)
        return cls(word_ids)

    @classmethod
    def from_groups(cls, path: str) -> "Synonyms":
        """Load a synonym-GROUP file (one whitespace-separated group per
        line, ``#`` comments skipped; group id = line ordinal) — the format
        of the shipped ``data/synonyms_en_compact.txt``.  A word appearing
        in several groups gets the union of their ids, so the matching rule
        is identical to the synset form."""
        word_ids: Dict[str, Set[int]] = {}
        with open(path, "rt", encoding="utf-8", errors="replace") as f:
            for gid, line in enumerate(f):
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                words = [w.lower() for w in line.split()]
                if len(words) < 2:
                    continue
                for w in words:
                    word_ids.setdefault(w, set()).add(gid)
        return cls(word_ids)

    @classmethod
    def load_flat(cls, path: str) -> "Synonyms":
        """Canonical flat form (``word\\tid id ...``, exceptions already
        folded) — the file ``get_meteor`` materializes for the C++ core."""
        return cls.load(path)

    def save_flat(self, path: str) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wt", encoding="utf-8") as f:
            for w in sorted(self.word_ids):
                ids = " ".join(str(i) for i in sorted(self.word_ids[w]))
                f.write(f"{w} {ids}\n")
        os.replace(tmp, path)

    def are_synonyms(self, a: str, b: str) -> bool:
        ia = self.word_ids.get(a)
        if not ia:
            return False
        ib = self.word_ids.get(b)
        return bool(ib) and not ia.isdisjoint(ib)


def _flat_synonyms_path(synsets_path: str, exceptions_path: Optional[str]):
    """Materialize (and cache) the folded flat synonym file next to the
    synsets resource, for loaders that want one file (the C++ core)."""
    flat = synsets_path + ".flat"
    deps = [synsets_path] + ([exceptions_path] if exceptions_path else [])
    if (not os.path.exists(flat)
            or any(os.path.getmtime(d) > os.path.getmtime(flat) for d in deps)):
        Synonyms.load(synsets_path, exceptions_path).save_flat(flat)
    return flat


def _compact_flat_path() -> Optional[str]:
    """Flat (word → ids) form of the shipped compact group table, cached in
    the user cache dir for the C++ core.  None if it cannot be written."""
    src = compact_synonyms_path()
    if not os.path.exists(src):
        return None
    flat = os.path.expanduser(f"{CACHE_DIR}/compact.flat")
    try:
        if (not os.path.exists(flat)
                or os.path.getmtime(src) > os.path.getmtime(flat)):
            os.makedirs(os.path.dirname(flat), exist_ok=True)
            Synonyms.from_groups(src).save_flat(flat)
        return flat
    except OSError:
        return None


def get_meteor(synonyms=None, paraphrase_path: Optional[str] = None,
               synonym_paths: Optional[Tuple[str, Optional[str]]] = None,
               function_words_path: Optional[str] = None):
    """Return the C++ METEOR core when built, else the Python scorer.

    Every resource defaults to the init-fetched file when present:
    paraphrase table, WordNet synonym tables, and the jar's
    ``function/en.words`` (hand-curated fallback otherwise).  Without the
    init-fetched WordNet tables the synonym stage falls back to the shipped
    compact curated table (``data/synonyms_en_compact.txt``) so the stage
    is live by default offline; ``CLIPCAP_METEOR_SYNONYMS=none`` disables
    it.  Measured corpus-level effect of each resource tier is documented
    in docs/performance.md ("METEOR resources").  ``synonyms`` may be a
    prebuilt ``Dict[str, Set[str]]``/``Synonyms`` — those configurations
    use the Python scorer."""
    if paraphrase_path is None:
        paraphrase_path = default_paraphrase_path()
    if function_words_path is None:
        function_words_path = default_function_words_path()
    use_compact = False
    if synonyms is None and synonym_paths is None:
        synonym_paths = default_synonym_paths()
        if (synonym_paths is None and os.environ.get(
                "CLIPCAP_METEOR_SYNONYMS", "").lower() != "none"):
            use_compact = os.path.exists(compact_synonyms_path())
    fwords = (load_function_words(function_words_path)
              if function_words_path else None)
    if synonyms is not None:
        tier = "the caller's synonym table"
    elif synonym_paths is not None:
        tier = f"the WordNet tables {synonym_paths[0]}"
    elif use_compact:
        tier = f"the shipped compact table {compact_synonyms_path()}"
    else:
        tier = "none (CLIPCAP_METEOR_SYNONYMS=none, or no table found)"
    logging.getLogger(__name__).info("METEOR synonym stage: %s", tier)
    if synonyms is None:
        compact_unavailable = False
        try:
            from clipcap_tpu_torch.native import meteor as native

            if synonym_paths is not None:
                syn_flat = _flat_synonyms_path(*synonym_paths)
            elif use_compact:
                syn_flat = _compact_flat_path()
                if syn_flat is None:
                    # The native core reads the flattened table from disk;
                    # an unwritable cache must NOT silently drop the
                    # synonym stage (identical configurations would score
                    # differently across machines) — fall through to the
                    # Python scorer, which loads the group table directly.
                    compact_unavailable = True
                    raise OSError("compact synonym table not materializable")
            else:
                syn_flat = None
            return native.Meteor(
                paraphrase_path=paraphrase_path,
                function_words_path=function_words_path,
                synonyms_path=syn_flat,
            )
        except Exception:
            if compact_unavailable:
                import warnings

                warnings.warn(
                    "METEOR: cannot cache the flattened compact synonym "
                    f"table (unwritable {CACHE_DIR}); using the "
                    "Python scorer so the synonym stage stays live.")
        if synonym_paths is not None:
            synonyms = Synonyms.load(*synonym_paths)
        elif use_compact:
            synonyms = Synonyms.from_groups(compact_synonyms_path())
    return Meteor(synonyms=synonyms, paraphrase_path=paraphrase_path,
                  function_words=fwords)


@dataclass(frozen=True)
class Match:
    """One match: hyp span [h, h+hl) ↔ ref span [r, r+rl), via ``stage``."""
    h: int
    hl: int
    r: int
    rl: int
    stage: int


class Meteor:
    def __init__(
        self,
        synonyms=None,
        paraphrase_path: Optional[str] = None,
        alpha: float = ALPHA,
        beta: float = BETA,
        gamma: float = GAMMA,
        delta: float = DELTA,
        stage_weights: Sequence[float] = STAGE_WEIGHTS,
        function_words: Optional[Set[str]] = None,
    ):
        # ``synonyms``: a Dict[word, Set[word]] (direct pairs) or a
        # ``Synonyms`` synset table (the jar's relation).
        self.synonyms = synonyms or {}
        self.function_words = (FUNCTION_WORDS if function_words is None
                               else function_words)
        self.paraphrases = (
            load_paraphrase_table(paraphrase_path) if paraphrase_path else {}
        )
        self._max_phrase = max(
            (len(p.split()) for p in self.paraphrases), default=1
        )
        self.alpha, self.beta, self.gamma, self.delta = alpha, beta, gamma, delta
        self.stage_weights = tuple(stage_weights)

    def method(self) -> str:
        return "METEOR"

    # ------------------------------------------------------------------
    # Alignment
    # ------------------------------------------------------------------

    def _syn_match(self, hw: str, rw: str) -> bool:
        if not self.synonyms:
            return False
        if isinstance(self.synonyms, Synonyms):
            return self.synonyms.are_synonyms(hw, rw)
        return (rw in self.synonyms.get(hw, ())
                or hw in self.synonyms.get(rw, ()))

    def _candidates(self, hyp: List[str], ref: List[str]) -> List[Match]:
        """All possible matches, every stage.  A word pair is attributed to
        its highest-priority (lowest-index) matching stage, like the jar."""
        cands: List[Match] = []
        h_stem = [snowball_stem(w) for w in hyp]
        r_stem = [snowball_stem(w) for w in ref]
        for i, hw in enumerate(hyp):
            for j, rw in enumerate(ref):
                if hw == rw:
                    cands.append(Match(i, 1, j, 1, 0))
                elif h_stem[i] == r_stem[j]:
                    cands.append(Match(i, 1, j, 1, 1))
                elif self._syn_match(hw, rw):
                    cands.append(Match(i, 1, j, 1, 2))
        if self.paraphrases:
            cands.extend(self._paraphrase_candidates(hyp, ref))
        return cands

    def _paraphrase_candidates(self, hyp: List[str], ref: List[str]) -> List[Match]:
        def spans(words):
            out = {}
            for a in range(len(words)):
                for ln in range(1, min(self._max_phrase, len(words) - a) + 1):
                    out.setdefault(" ".join(words[a:a + ln]), []).append((a, ln))
            return out

        h_spans, r_spans = spans(hyp), spans(ref)
        cands: List[Match] = []
        seen = set()
        for h_phrase, h_locs in h_spans.items():
            for r_phrase in self.paraphrases.get(h_phrase, ()):
                for r_loc in r_spans.get(r_phrase, ()):
                    for h_loc in h_locs:
                        key = (h_loc, r_loc)
                        if key not in seen:
                            seen.add(key)
                            cands.append(Match(h_loc[0], h_loc[1],
                                               r_loc[0], r_loc[1], 3))
        for r_phrase, r_locs in r_spans.items():
            for h_phrase in self.paraphrases.get(r_phrase, ()):
                for h_loc in h_spans.get(h_phrase, ()):
                    for r_loc in r_locs:
                        key = (h_loc, r_loc)
                        if key not in seen:
                            seen.add(key)
                            cands.append(Match(h_loc[0], h_loc[1],
                                               r_loc[0], r_loc[1], 3))
        return cands

    @staticmethod
    def _count_chunks(matches: Sequence[Match]) -> int:
        """Chunks = maximal runs of matches adjacent in both sentences."""
        if not matches:
            return 0
        ordered = sorted(matches, key=lambda m: (m.h, m.r))
        chunks = 1
        for a, b in zip(ordered, ordered[1:]):
            if not (b.h == a.h + a.hl and b.r == a.r + a.rl):
                chunks += 1
        return chunks

    @classmethod
    def _objective(cls, matches: Sequence[Match]) -> Tuple[int, int, int]:
        """Jar aligner objective, to MAXIMIZE lexicographically:
        (words covered, −chunks, −total |h−r| start distance)."""
        covered = sum(m.hl + m.rl for m in matches)
        dist = sum(abs(m.h - m.r) for m in matches)
        return (covered, -cls._count_chunks(matches), -dist)

    def _align(self, hyp: List[str], ref: List[str]) -> List[Match]:
        """Beam search (width 40, like the jar) over the candidate set."""
        cands = self._candidates(hyp, ref)
        cands.sort(key=lambda m: (m.h, m.r, m.stage, m.hl, m.rl))
        # state: (h_mask, r_mask, matches tuple)
        beam: List[Tuple[int, int, Tuple[Match, ...]]] = [(0, 0, ())]
        for m in cands:
            h_bits = ((1 << m.hl) - 1) << m.h
            r_bits = ((1 << m.rl) - 1) << m.r
            new = []
            for hm, rm, chosen in beam:
                if not (hm & h_bits) and not (rm & r_bits):
                    new.append((hm | h_bits, rm | r_bits, chosen + (m,)))
            if new:
                beam.extend(new)
                beam.sort(key=lambda s: self._objective(s[2]), reverse=True)
                del beam[BEAM_WIDTH:]
        return list(max((s[2] for s in beam), key=self._objective))

    # ------------------------------------------------------------------
    # Scoring
    # ------------------------------------------------------------------

    def _word_weight(self, w: str) -> float:
        return (1.0 - self.delta) if w in self.function_words else self.delta

    def _segment_stats(self, hyp: List[str], ref: List[str]) -> dict:
        """Sufficient statistics for one (hyp, ref) pair."""
        matches = self._align(hyp, ref)

        w_h = w_r = 0.0
        for m in matches:
            sw = self.stage_weights[m.stage]
            w_h += sw * sum(self._word_weight(hyp[k]) for k in range(m.h, m.h + m.hl))
            w_r += sw * sum(self._word_weight(ref[k]) for k in range(m.r, m.r + m.rl))

        return {
            "matches_h": sum(m.hl for m in matches),
            "matches_r": sum(m.rl for m in matches),
            "chunks": self._count_chunks(matches),
            "w_matched_h": w_h,
            "w_matched_r": w_r,
            "w_len_h": sum(self._word_weight(w) for w in hyp),
            "w_len_r": sum(self._word_weight(w) for w in ref),
        }

    def _score_from_stats(self, st: dict) -> float:
        if st["matches_h"] == 0 or st["w_len_h"] == 0 or st["w_len_r"] == 0:
            return 0.0
        p = st["w_matched_h"] / st["w_len_h"]
        r = st["w_matched_r"] / st["w_len_r"]
        if p == 0 or r == 0:
            return 0.0
        fmean = (p * r) / (self.alpha * p + (1 - self.alpha) * r)
        mean_matches = 0.5 * (st["matches_h"] + st["matches_r"])
        frag = st["chunks"] / mean_matches if st["chunks"] else 0.0
        penalty = self.gamma * (frag ** self.beta)
        return (1.0 - penalty) * fmean

    def score_segment(self, hypothesis: str, references: Sequence[str]) -> float:
        hyp = normalize(hypothesis)
        best = 0.0
        for ref in references:
            best = max(best, self._score_from_stats(
                self._segment_stats(hyp, normalize(ref))))
        return best

    # Public sufficient-statistics interface (the jar's SCORE/EVAL stdio
    # protocol is built on these — eval/meteor_stdio.py; same 7-value
    # order as the native core's ccn_meteor_stats).
    def segment_stats(self, hypothesis: str, reference: str) -> List[float]:
        st = self._segment_stats(normalize(hypothesis), normalize(reference))
        return [float(st[k]) for k in _STATS_KEYS]

    def score_from_stats(self, stats: Sequence[float]) -> float:
        return self._score_from_stats(dict(zip(_STATS_KEYS, stats)))

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        """coco-caption interface: per-image score = best ref; corpus score =
        score of summed sufficient statistics over each image's best
        reference (the jar's EVAL aggregation)."""
        keys = list(gts.keys())
        per_image: List[float] = []
        agg = dict.fromkeys(_STATS_KEYS, 0.0)
        for key in keys:
            hyp = normalize(res[key][0])
            best_score, best_stats = 0.0, None
            for ref in gts[key]:
                st = self._segment_stats(hyp, normalize(ref))
                sc = self._score_from_stats(st)
                if best_stats is None or sc > best_score:
                    best_score, best_stats = sc, st
            per_image.append(best_score)
            for k in agg:
                agg[k] += best_stats[k]
        return self._score_from_stats(agg), per_image
