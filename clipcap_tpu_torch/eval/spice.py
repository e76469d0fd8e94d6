"""SPICE scorer — native scene-graph harness.

The reference shells out to ``spice-1.0.jar`` (Stanford scene-graph parser +
CoreNLP dependency parsing + lmdb cache,
ClipCap's clipcap/eval/pycocoevalcap/spice/spice.py:60-93).  Full
dependency parsing is the documented hard part of replacing it
(SURVEY.md §2.2); this module implements the SPICE harness natively:

* the default tuple extractor runs a real dependency-parsing pipeline —
  averaged-perceptron POS tagging (``eval/postag.py``), an arc-standard
  transition parser (``eval/depparse.py``), and scene-graph rules over the
  parses (``eval/scene_graph.py``), assembled in ``eval/spice_parser.py``;
* a dependency-free *chunker* extractor (``extract_tuples_chunker``) is
  kept as a documented fallback (``CLIPCAP_SPICE_EXTRACTOR=chunker``) —
  objects/attributes/relations from greedily chunked noun phrases;
* the SPICE metric itself: F1 over the union of proposition tuples between
  the candidate graph and the merged reference graph (Anderson et al. 2016),
  with per-category subscores (All/Object/Attribute/Relation) in the same
  output shape the Java scorer emits.

Measured extractor fidelity against hand-annotated gold scene graphs
(annotate-before-run protocol, five corpora in tests/): parser P=0.953
R=0.948 on the held-out verbatim-COCO corpus vs chunker P=0.899 R=0.927.
Absolute values can still differ from Java SPICE; the F-scoring harness
accepts externally parsed graphs too (``score_graphs``), so an even
stronger parser can be dropped in without touching the metric.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Set, Tuple

from clipcap_tpu_torch.eval.meteor import FUNCTION_WORDS
from clipcap_tpu_torch.eval.porter import porter_stem

Tuples = Set[Tuple[str, ...]]

# Small closed classes for the chunker.
ARTICLES = {"a", "an", "the", "some", "any", "this", "that", "these", "those",
            "his", "her", "its", "their", "our", "my", "your", "no", "each",
            "every", "both", "few", "several", "many", "much"}
# Numbers are NOT articles: CoreNLP's nummod becomes a SPICE attribute
# ("two dogs" → (dogs, two)), so they stay content words and fall into the
# NP's modifier slots like any other attribute.
NUMBERS = {"two", "three", "four", "five", "six", "seven", "eight", "nine",
           "ten"}
PREPOSITIONS = {"in", "on", "at", "by", "with", "near", "under", "over",
                "above", "below", "behind", "beside", "between", "among",
                "around", "inside", "outside", "against", "along", "across",
                "through", "onto", "into", "atop", "upon", "underneath",
                "next", "of", "to", "from", "off", "past", "beneath",
                "toward", "towards", "during", "throughout",
                # phrasal-verb particles: links, never NP heads ("blowing
                # OUT the candle", "holding UP a fish"); the verb wins the
                # relation label so the particle is absorbed
                "out", "up", "down",
                # collapsed multiword prepositions (the pre-pass joins the
                # token runs below into one link token, matching CoreNLP's
                # multiword nmod labels — 'front' must not chunk as a noun)
                "in front of", "on top of", "next to", "close to"}
# Token runs collapsed into single prepositional link tokens, longest first.
MULTIWORD_PREPS = [("in", "front", "of"), ("on", "top", "of"),
                   ("next", "to"), ("close", "to")]


def collapse_multiword(tokens) -> List[str]:
    """Collapse multiword-preposition token runs into single link tokens
    ("in front of" etc. — CoreNLP emits them as one nmod label).  Shared by
    both extractors (the chunker here and ``spice_parser``) so they always
    see identical tokens."""
    words = [w for w in tokens if w]
    out: List[str] = []
    i = 0
    while i < len(words):
        for run in MULTIWORD_PREPS:
            if tuple(words[i:i + len(run)]) == run:
                out.append(" ".join(run))
                i += len(run)
                break
        else:
            out.append(words[i])
            i += 1
    return out
# Clause boundaries: the relation scan must not chain a verb across these
# ("a dog runs WHILE a cat sleeps" is two clauses, not (dog, runs, cat)).
CLAUSE_BREAKS = {"while"}
COPULAS = {"is", "are", "was", "were", "be", "been", "being", "looks",
           "seems", "appears"}
CONJUNCTIONS = {"and", "or"}

_ADJ_SUFFIXES = ("ful", "ous", "ish", "ive", "less", "able", "ible", "al",
                 "ic", "y", "ed", "en")

# Closed class of caption-frequent adjectives that don't end in an
# adjectival suffix — used to recognize coordinated attributes
# ("a red and blue umbrella") where the first conjunct would otherwise
# chunk as its own object NP.
ADJECTIVES = {
    "red", "blue", "green", "black", "white", "brown", "gray", "grey",
    "orange", "purple", "pink", "yellow", "golden", "dark", "light",
    "big", "small", "large", "little", "tall", "short", "long", "old",
    "young", "new", "wide", "narrow", "high", "low", "bright", "open",
    "full", "empty", "wet", "dry", "clean", "dirty",
    "barefoot", "asleep", "awake", "alone",
}


def _plural_noun(word: str) -> bool:
    """Surface-plural noun heuristic for asyndetic-list splitting."""
    return (len(word) > 3 and word.endswith("s")
            and not word.endswith(("ss", "us", "is"))
            and word not in ADJECTIVES)


# Predicative-tending adjectives that routinely trail their noun inside an
# NP chunk ("a vase full of flowers", "a young boy barefoot") — safe to
# demote from the head slot, unlike noun/adjective homographs ("light").
_POSTNOMINAL_ADJ = {"full", "empty", "open", "closed", "barefoot", "asleep",
                    "awake", "alone"}

# Degree/manner adverbs that modify adjectives, not nouns — CoreNLP tags
# them advmod and SPICE graphs drop them ("a PARTLY cloudy sky" attributes
# only "cloudy").  Closed set: many -ly words are adjectives ("curly",
# "friendly", "lovely"), so no suffix heuristic.
ADVERBS = {"partly", "partially", "very", "really", "extremely", "slightly",
           "mostly", "fully", "fairly", "freshly", "newly", "brightly",
           "dimly", "neatly", "halfway"}

# Base-form verbs recognized as infinitives directly after "to"
# ("preparing TO BLOW out her candle"); outside that position base forms
# double as nouns too often to risk ("a park", "a watch").
BASE_VERBS = {"blow", "hold", "eat", "ride", "jump", "catch", "throw",
              "play", "cut", "sit", "stand", "walk", "run", "fly", "swim",
              "drink", "hit", "kick", "climb", "cross", "take", "get",
              "go", "make", "see", "watch", "feed", "pet", "touch",
              "read", "write", "grab", "reach", "serve", "hang"}


def _looks_like_adjective(word: str) -> bool:
    return word in ADJECTIVES or (
        word.endswith(_ADJ_SUFFIXES) and word not in FUNCTION_WORDS
    )

# -ing words that are overwhelmingly NOUNS in captions — the participle
# heuristic's article guard only covers the directly-post-article position
# ("a painting"), not "a brick BUILDING" or "an old PAINTING".
ING_NOUNS = {"building", "painting", "ceiling", "railing", "awning",
             "clothing", "icing", "frosting", "evening", "morning"}

# Common caption verbs, INFLECTED forms only — base forms ("park", "top",
# "watch", …) double as nouns far too often in captions to risk; captions
# overwhelmingly use 3rd-person/past/participial forms anyway.
VERBS = {
    "runs", "ran", "sits", "sat", "stands", "stood", "sleeps", "slept",
    "walks", "walked", "plays", "played", "holds", "held", "wears", "wore",
    "rides", "rode", "jumps", "jumped", "eats", "ate", "drinks", "drank",
    "flies", "flew", "swims", "swam", "drives", "drove", "watches",
    "watched", "carries", "carried", "catches", "caught", "throws",
    "threw", "kicks", "kicked", "hits", "reads", "writes", "wrote",
    "talks", "talked", "smiled", "smiles", "waved", "waves", "pointed",
    "leans", "leaned", "rests", "rested", "grazes", "grazed", "perches",
    "perched", "lays", "lies", "hangs", "hung", "parked", "fills",
    "filled", "covers", "covered", "topped", "surrounds", "surrounded",
    "stares", "grabs", "pulls", "pushes",
    "travels", "traveled", "floats", "floated", "docks", "docked",
    "swings", "swung", "paints", "painted", "lined", "lines", "serves",
    "served", "sails", "sailed", "splashes", "dives", "climbs", "climbed",
    "crosses", "crossed", "passes", "passed", "lands", "landed", "soars",
    "glides", "races", "raced", "skis", "surfs", "surfed", "skates",
    "strolls", "wades", "approaches", "leaps", "leaped", "chases",
    "chased", "feeds", "fed", "licks", "sniffs", "barks", "spins",
    "rolls", "slides", "bounces", "kneels", "squats", "crouches",
    "crouched", "stretches", "poses", "posed", "waits", "waited",
    "looks", "gazes", "laughs", "speaks", "spoke", "chats",
    "inhales", "exhales", "blows", "blew", "cuts", "pets", "touches",
    "touched", "grins", "yawns", "bends", "crawls", "crawled", "dances",
    "danced", "sings", "sang", "shouts", "screams", "whistles",
}


def _is_verb(word: str, prev_word: str | None) -> bool:
    """Heuristic POS: finite/participial verb.  -ing words are verbs unless
    directly after an article ('a painting' is a noun); closed-class words
    never are ('during'); base forms only as infinitives after 'to'."""
    if word in PREPOSITIONS or word in FUNCTION_WORDS or word in ARTICLES:
        return False
    if word in VERBS:
        return True
    if prev_word == "to" and word in BASE_VERBS:
        return True
    if (word.endswith("ing") and len(word) > 4 and prev_word not in ARTICLES
            and word not in ING_NOUNS):
        return True
    return False


# Irregular past participles that appear attributively in captions.
_IRREGULAR_PARTICIPLES = {"broken", "fallen", "hidden", "frozen", "worn",
                          "torn", "drawn"}


def _attributive_participle(words: Sequence[str], j: int, n: int) -> bool:
    """A PAST participle directly before a noun is an amod, not a relation
    verb ("parked cars", "sliced bread") — CoreNLP tags these amod.  Only
    past forms qualify: -ing verbs before bare nouns are usually transitive
    with a bare-plural object ("a man riding horses")."""
    w = words[j]
    if not (w.endswith("ed") or w in _IRREGULAR_PARTICIPLES):
        return False
    if j + 1 >= n:
        return False
    nxt = words[j + 1]
    return (nxt not in ARTICLES and nxt not in PREPOSITIONS
            and nxt not in COPULAS and nxt not in CONJUNCTIONS
            and nxt not in FUNCTION_WORDS and nxt not in CLAUSE_BREAKS
            and nxt != "'s" and not _is_verb(nxt, w))


def _looks_adjectival(word: str, next_word: str) -> bool:
    """Heuristic POS: a word modifying a following noun."""
    if word in ARTICLES or word in PREPOSITIONS or word in COPULAS:
        return False
    if next_word is None:
        return False
    return True  # inside a noun phrase, all non-final content words modify the head


def extract_tuples_chunker(tokens: Sequence[str]) -> Tuples:
    """Caption tokens → semantic proposition tuples (chunker extractor).

    Grammar sketch (greedy, left-to-right):
      NP  := ART* (MOD)* HEAD        → object(HEAD) + attribute(HEAD, MOD)*
      NP1 P NP2                      → relation(HEAD1, P, HEAD2)
      NP1 V NP2  (V = non-copula content verb between NPs)
                                     → relation(HEAD1, V, HEAD2)
      NP COP ADJ                     → attribute(HEAD, ADJ)
    """
    # Degree/manner adverbs modify adjectives or verbs, never head or
    # attribute a noun — drop them before chunking ("partly cloudy sky").
    words = [w for w in collapse_multiword(tokens) if w not in ADVERBS]
    tuples: Tuples = set()

    # Chunk into NPs and connectors.
    chunks: List[Tuple[str, object]] = []  # ("np", (head, mods)) | ("link", word)
    i = 0
    n = len(words)
    while i < n:
        w = words[i]
        if w in CONJUNCTIONS:
            chunks.append(("conj", w))
            i += 1
            continue
        if w in CLAUSE_BREAKS:
            chunks.append(("brk", w))
            i += 1
            continue
        if w == "'s":
            chunks.append(("poss", w))
            i += 1
            continue
        if w in PREPOSITIONS or w in COPULAS or (w in FUNCTION_WORDS and w not in ARTICLES):
            chunks.append(("link", w))
            i += 1
            continue
        if (_is_verb(w, words[i - 1] if i else None)
                and not _attributive_participle(words, i, n)):
            chunks.append(("link", w))
            i += 1
            continue
        # NP: optional articles, then content words until a link/verb/end.
        # A known verb breaks the NP even in first position ("a dog that
        # SITS on ..." — relative pronouns consume the article slot, so the
        # verb would otherwise become the NP head); _is_verb's article
        # guard keeps deverbal nouns ("a painting") as heads.
        j = i
        while j < n and words[j] in ARTICLES:
            j += 1
        content = []
        while j < n and words[j] not in PREPOSITIONS and words[j] not in COPULAS \
                and words[j] not in CONJUNCTIONS and words[j] not in FUNCTION_WORDS \
                and words[j] not in CLAUSE_BREAKS and words[j] != "'s" \
                and (not _is_verb(words[j], words[j - 1])
                     or _attributive_participle(words, j, n)):
            content.append(words[j])
            j += 1
        if content:
            # Head = last content word, unless that word is a predicative-
            # tending adjective trailing a real noun ("a vase FULL of ...")
            # — then the noun heads and the adjective modifies.  The closed
            # POSTNOMINAL set avoids demoting noun/adjective homographs
            # ("a traffic light", "an orange").
            head_pos = len(content) - 1
            if content[head_pos] in _POSTNOMINAL_ADJ:
                head_pos = max((k for k, w2 in enumerate(content)
                                if w2 not in ADJECTIVES), default=head_pos)
            head = content[head_pos]
            mods = content[:head_pos] + content[head_pos + 1:]
            chunks.append(("np", (head, mods)))
            i = j
        else:
            # bare function word not caught above
            chunks.append(("link", words[i]))
            i += 1

    # Possessives: NP 's NP → the possessor is its own object related by
    # "have" (CoreNLP scene graphs map nmod:poss that way), and the chunk
    # stream continues with the possessed NP so later links attach to IT
    # ("a man 's hat on a chair" → (man, have, hat) + (hat, on, chair)).
    i = 0
    while i + 2 < len(chunks):
        if (chunks[i][0] == "np" and chunks[i + 1][0] == "poss"
                and chunks[i + 2][0] == "np"):
            p_head, p_mods = chunks[i][1]
            tuples.add((p_head,))
            for m in p_mods:
                tuples.add((p_head, m))
            tuples.add((p_head, "have", chunks[i + 2][1][0]))
            del chunks[i:i + 2]
            continue
        i += 1

    # Coordinated attributes: an NP whose head is adjectival, joined by a
    # conjunction to a following NP, contributes its words as modifiers of
    # that NP's head ("a red and blue umbrella" → (umbrella, red),
    # (umbrella, blue) — Java SPICE distributes conjoined amods the same way).
    # Only the CLOSED adjective set qualifies here: the suffix heuristic
    # matches common caption nouns ("boy", "baby", "lady", "bed"), which
    # would wrongly merge "a boy and a girl ..." into one NP instead of a
    # coordination group that distributes the relation to both heads.
    i = 0
    while i + 2 < len(chunks):
        if (chunks[i][0] == "np" and chunks[i + 1][0] == "conj"
                and chunks[i + 2][0] == "np"):
            head_a, mods_a = chunks[i][1]
            head_b, mods_b = chunks[i + 2][1]
            if head_a in ADJECTIVES and not _looks_like_adjective(head_b):
                chunks[i + 2] = ("np", (head_b, mods_a + [head_a] + mods_b))
                del chunks[i:i + 2]
                continue
        i += 1

    # Post-verbal bare adjectives are adverbial/resultative, not objects
    # ("flies HIGH above the beach", "sits OPEN on a desk"): demote to
    # links so the relation scan passes through them.
    for idx in range(len(chunks)):
        if (chunks[idx][0] == "np" and not chunks[idx][1][1]
                and chunks[idx][1][0] in ADJECTIVES
                and idx > 0 and chunks[idx - 1][0] == "link"
                and _is_verb(chunks[idx - 1][1], None)):
            chunks[idx] = ("link", chunks[idx][1][0])

    # Asyndetic lists: the PTB pipeline strips commas, so "plates, cups and
    # bowls" arrives as "plates cups and bowls" and the first nouns chunk
    # as a compound.  At a conjunction boundary, plural non-adjective
    # "modifiers" are elided conjuncts — split them into the coordination.
    # The modifier itself must be plural: a singular modifier under a
    # plural head is a compound noun, not a list ("palm trees and a
    # bench" keeps NP(trees, [palm]); splitting NP(palm) would add a
    # bogus object and distribute the group's relations to it).
    idx = 0
    while idx < len(chunks):
        at_conj = ((idx + 1 < len(chunks) and chunks[idx + 1][0] == "conj")
                   or (idx > 0 and chunks[idx - 1][0] == "conj"))
        if chunks[idx][0] == "np" and at_conj:
            head, mods = chunks[idx][1]
            split = [m for m in mods
                     if _plural_noun(m)
                     and m not in ADJECTIVES and not _looks_like_adjective(m)]
            if split:
                keep = [m for m in mods if m not in split]
                repl: List[Tuple[str, object]] = []
                for m in split:
                    repl.extend([("np", (m, [])), ("conj", "and")])
                repl.append(("np", (head, keep)))
                chunks[idx:idx + 1] = repl
                idx += len(repl)
                continue
        idx += 1

    # Coordination groups: NP (conj NP)* — conjoined heads share relations
    # ("a man and a woman sitting on a bench" → both (man, sitting, bench)
    # and (woman, sitting, bench), matching the parser's distributed nsubj).
    group_of: Dict[int, List[int]] = {}
    idx = 0
    while idx < len(chunks):
        if chunks[idx][0] != "np":
            idx += 1
            continue
        group = [idx]
        j = idx
        while (j + 2 < len(chunks) and chunks[j + 1][0] == "conj"
               and chunks[j + 2][0] == "np"):
            j += 2
            group.append(j)
        for g in group:
            group_of[g] = group
        idx = j + 1

    # Copular predicates: NP (that|which|who)? COP (V-ed)? NP — the
    # attribute distributes over the predicate's conjunction group ("the
    # sky is dark and cloudy"); adjective-headed predicates do not emit
    # object tuples of their own; nominal predicates stay objects ("the
    # man is a doctor").  A passive/resultative participle between the
    # copula and an ADJECTIVE-headed predicate contributes a 2-tuple and
    # the predicate becomes attributes ("walls that are painted baby
    # blue" → (walls, painted) + (walls, blue)); with a noun-headed
    # predicate the relation scan handles it instead ("is holding a
    # balloon").
    # Adjective-headed copular predicates become attributes of the subject:
    # their NP chunk is consumed — emitted neither as an object nor as a
    # relation target.
    pred_consumed: set = set()
    _REL_PRONOUNS = {"that", "which", "who"}
    for a in range(len(chunks)):
        if chunks[a][0] != "np":
            continue
        b = a + 1
        if (b < len(chunks) and chunks[b][0] == "link"
                and chunks[b][1] in _REL_PRONOUNS):
            b += 1
        if not (b < len(chunks) and chunks[b][0] == "link"
                and chunks[b][1] in COPULAS):
            continue
        b += 1
        participles: List[str] = []
        while (b < len(chunks) and chunks[b][0] == "link"
               and (chunks[b][1].endswith("ed")
                    or chunks[b][1] in _IRREGULAR_PARTICIPLES)
               and _is_verb(chunks[b][1], None)):
            participles.append(chunks[b][1])
            b += 1
        if not (b < len(chunks) and chunks[b][0] == "np"):
            continue
        head = chunks[a][1][0]
        pred_head = chunks[b][1][0]
        if participles and not (pred_head in ADJECTIVES
                                or _looks_like_adjective(pred_head)):
            continue  # progressive/passive with a real object NP
        for g in group_of.get(b, [b]):
            attr_head, attr_mods = chunks[g][1]
            tuples.add((head, attr_head))
            for m in attr_mods:
                tuples.add((head, m))
            if attr_head in ADJECTIVES or _looks_like_adjective(attr_head):
                pred_consumed.add(g)
        for v in participles:
            tuples.add((head, v))

    # Emit object/attribute tuples.
    np_list = [(idx, c[1]) for idx, c in enumerate(chunks)
               if c[0] == "np" and idx not in pred_consumed]
    for _, (head, mods) in np_list:
        tuples.add((head,))
        for m in mods:
            tuples.add((head, m))

    # Relations: NP (link...) NP with the link word(s) as the relation label.
    # Scan starts at the LAST member of a subject coordination group and the
    # relation is distributed over every subject head; a coordinated object
    # group likewise receives the relation on each of its heads.
    # ``rel_into[obj] = (subj, rel)`` records the chain for subject lifting:
    # * verb relations lift to the clause subject through post-nominal
    #   PPs/participles ("a man in a jacket RIDING a bicycle" → man rides),
    #   but NOT through "of" chains, whose content noun acts ("a group of
    #   people STANDING ..." → people stand);
    # * preposition relations lift only through "of" chains — the container
    #   locates ("a bowl of soup ON the counter" → bowl on counter).
    rel_into: Dict[int, Tuple[int, str]] = {}

    def link_is_verb(ls: List[str], k: int) -> bool:
        # positional check so infinitives register ("to BLOW")
        return _is_verb(ls[k], ls[k - 1] if k else None)

    for a in range(len(chunks)):
        if chunks[a][0] != "np" or group_of[a][-1] != a:
            continue
        # find next NP
        links: List[str] = []
        saw_copula = False
        rel_clause = False  # a relative pronoun OPENED this predicate chain
        for b in range(a + 1, len(chunks)):
            kind, val = chunks[b]
            if kind in ("link", "conj", "brk"):
                if kind == "link":
                    if val in COPULAS:
                        saw_copula = True
                    elif val in _REL_PRONOUNS:  # never relation labels
                        # Leading "that/which/who" binds the predicate to
                        # THIS noun ("a dog THAT is on a leash" → dog on
                        # leash, not its owner); after a verb it is just a
                        # determiner ("chasing THAT ball") and the normal
                        # subject lifting applies.
                        if not links and not saw_copula:
                            rel_clause = True
                    else:
                        links.append(val)  # type: ignore[arg-type]
                if kind in ("conj", "brk"):
                    # VP coordination / gerund continuation: "smiling and
                    # holding a balloon", "sitting while eating" — a verb
                    # right after the boundary keeps the same subject with
                    # a FRESH relation chain (a relative-clause subject
                    # stays the subject: "that is sitting and wearing a
                    # hat"); anything else starts a new clause.
                    nxt = chunks[b + 1] if b + 1 < len(chunks) else None
                    if (nxt is not None and nxt[0] == "link"
                            and _is_verb(nxt[1], None)):
                        links = []
                        saw_copula = False
                        continue
                    break
                continue
            if kind == "np":
                if b in pred_consumed:
                    break  # resultative predicate, already an attribute
                # Relation label priority: LAST verb (control chains keep
                # the semantic verb: "preparing to BLOW out her candle"),
                # then preposition, then last link.
                verb_ks = [k for k in range(len(links))
                           if link_is_verb(links, k)]
                rel = links[verb_ks[-1]] if verb_ks else None
                if rel is None:
                    rel = next((l for l in links if l in PREPOSITIONS), None)
                if rel is None and links:
                    rel = links[-1]
                if rel:
                    subj_idx = group_of[a][0]
                    if (verb_ks or saw_copula) and not rel_clause:
                        # Verbs — and copular predicates ("a man in a red
                        # hat IS ON a motorcycle") — act for the clause
                        # subject: lift through non-of chains.  A leading
                        # relative pronoun makes THIS noun the clause
                        # subject instead ("a woman with a dog THAT IS ON
                        # a leash" → (dog, on, leash)); of-chain container
                        # lifting below still applies ("a bowl of soup
                        # that is on the counter" → bowl on counter).
                        seen_l: set = set()
                        while (subj_idx in rel_into and subj_idx not in seen_l
                               and rel_into[subj_idx][1] != "of"):
                            seen_l.add(subj_idx)
                            subj_idx = rel_into[subj_idx][0]
                    elif rel != "of":
                        # Containers locate ("a bowl of soup ON the
                        # counter" → bowl on counter) — but an of-chain
                        # keeps attaching to the nearest noun ("the wheel
                        # OF a bicycle" under "the appearance of ...").
                        while (subj_idx in rel_into
                               and rel_into[subj_idx][1] == "of"):
                            subj_idx = rel_into[subj_idx][0]
                    subj_group = group_of.get(subj_idx, [subj_idx])
                    for ga in subj_group:
                        for gb in group_of[b]:
                            tuples.add((chunks[ga][1][0], rel, chunks[gb][1][0]))
                    for gb in group_of[b]:
                        rel_into.setdefault(gb, (group_of[a][0], rel))
                    # Control verbs before an infinitive keep their own
                    # subject link as a 2-tuple ("girl preparing to blow
                    # out her candle" → (girl, preparing) too).
                    for k in verb_ks[:-1]:
                        if k + 1 < len(links) and links[k + 1] == "to":
                            for ga in subj_group:
                                tuples.add((chunks[ga][1][0], links[k]))
                break

    # Intransitive verbs: NP V with no object NP before a conjunction/end
    # becomes an attribute-like 2-tuple ('a cat sleeps' → (cat, sleeps)).
    for a in range(len(chunks)):
        if chunks[a][0] != "link" or not _is_verb(chunks[a][1], None):
            continue
        prev_np = next((chunks[b][1][0] for b in range(a - 1, -1, -1)
                        if chunks[b][0] == "np"), None)
        if prev_np is None:
            continue
        has_object = False
        for b in range(a + 1, len(chunks)):
            if chunks[b][0] in ("conj", "brk"):
                break
            if chunks[b][0] == "np":
                has_object = True
                break
        if not has_object:
            tuples.add((prev_np, chunks[a][1]))

    return tuples


def extract_tuples(tokens: Sequence[str]) -> Tuples:
    """Caption tokens → semantic proposition tuples.

    Default path: POS tagging + arc-standard dependency parsing + scene
    rules (``eval/spice_parser.py``), the native analog of the CoreNLP
    pipeline inside ``spice-1.0.jar``.  Held-out accuracy on verbatim COCO
    captions: P=0.953 R=0.948 first-measurement (tests/test_spice_coco5.py)
    vs the chunker's 0.899/0.927.  Set ``CLIPCAP_SPICE_EXTRACTOR=chunker``
    to fall back to the dependency-free chunker above (no model training,
    slightly lower fidelity)."""
    if os.environ.get("CLIPCAP_SPICE_EXTRACTOR", "parser") == "chunker":
        return extract_tuples_chunker(tokens)
    from clipcap_tpu_torch.eval.spice_parser import extract_tuples_parsed

    return extract_tuples_parsed(tokens)


def _stem_tuple(t: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(porter_stem(w) for w in t)


def _f1(cand: Tuples, ref: Tuples) -> Dict[str, float]:
    cand_s = {_stem_tuple(t) for t in cand}
    ref_s = {_stem_tuple(t) for t in ref}
    tp = len(cand_s & ref_s)
    p = tp / len(cand_s) if cand_s else 0.0
    r = tp / len(ref_s) if ref_s else 0.0
    f = 2 * p * r / (p + r) if (p + r) > 0 else 0.0
    return {"p": p, "r": r, "f": f}


def _by_category(tuples: Tuples, arity: int) -> Tuples:
    return {t for t in tuples if len(t) == arity}


class Spice:
    def method(self) -> str:
        return "SPICE"

    def score_graphs(self, cand: Tuples, refs_merged: Tuples) -> Dict:
        """SPICE F-scores for pre-extracted tuple sets (per-category maps in
        the Java scorer's output shape, spice.py:80-93)."""
        return {
            "All": _f1(cand, refs_merged),
            "Object": _f1(_by_category(cand, 1), _by_category(refs_merged, 1)),
            "Attribute": _f1(_by_category(cand, 2), _by_category(refs_merged, 2)),
            "Relation": _f1(_by_category(cand, 3), _by_category(refs_merged, 3)),
        }

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[Dict]]:
        keys = list(gts.keys())
        per_image: List[Dict] = []
        fs: List[float] = []
        for key in keys:
            cand = extract_tuples(res[key][0].split())
            merged: Tuples = set()
            for ref in gts[key]:
                merged |= extract_tuples(ref.split())
            scores = self.score_graphs(cand, merged)
            per_image.append(scores)
            fs.append(scores["All"]["f"])
        mean_f = sum(fs) / len(fs) if fs else 0.0
        return mean_f, per_image
