"""Snowball English ("Porter2") stemmer.

METEOR 1.5's stem matcher uses ``org.tartarus.snowball.ext.englishStemmer``
(the Snowball English algorithm), not the original 1980 Porter stemmer —
this module implements that algorithm from the published definition
(snowballstem.org "The English (Porter2) stemming algorithm") so the METEOR
stem stage matches the reference jar's
(ClipCap's clipcap/eval/pycocoevalcap/meteor/meteor.py:21-28 drives
``meteor-1.5.jar -l en``, whose English config registers the Snowball
stemmer).

Validated in tests/test_eval.py against nltk's ``SnowballStemmer("english")``
(an independent implementation of the same definition) over a large
generated vocabulary.
"""
from __future__ import annotations

_VOWELS = "aeiouy"
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_VALID = "cdeghkmnrt"

_EXCEPTIONS = {
    "skis": "ski", "skies": "sky",
    "dying": "die", "lying": "lie", "tying": "tie",
    "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
    "sky": "sky", "news": "news", "howe": "howe",
    "atlas": "atlas", "cosmos": "cosmos", "bias": "bias", "andes": "andes",
}
_EXCEPTIONS_POST_1A = frozenset(
    ("inning", "outing", "canning", "herring", "earring",
     "proceed", "exceed", "succeed")
)
_SPECIAL_R1_PREFIXES = ("gener", "commun", "arsen")

_STEP2 = (
    ("ization", "ize"), ("ational", "ate"), ("ousness", "ous"),
    ("iveness", "ive"), ("fulness", "ful"), ("tional", "tion"),
    ("biliti", "ble"), ("lessli", "less"), ("entli", "ent"),
    ("ation", "ate"), ("alism", "al"), ("aliti", "al"), ("ousli", "ous"),
    ("iviti", "ive"), ("fulli", "ful"), ("enci", "ence"), ("anci", "ance"),
    ("abli", "able"), ("izer", "ize"), ("ator", "ate"), ("alli", "al"),
    ("bli", "ble"), ("ogi", "og"), ("li", ""),
)
_STEP3 = (
    ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
    ("icate", "ic"), ("iciti", "ic"), ("ative", ""), ("ical", "ic"),
    ("ness", ""), ("ful", ""),
)
_STEP4 = (
    "ement", "ance", "ence", "able", "ible", "ment",
    "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
    "ion", "al", "er", "ic",
)


def _is_vowel(w: str, i: int) -> bool:
    return w[i] in _VOWELS


def _regions(w: str):
    """Return (r1, r2) start offsets."""
    r1 = len(w)
    for pre in _SPECIAL_R1_PREFIXES:
        if w.startswith(pre):
            r1 = len(pre)
            break
    else:
        for i in range(1, len(w)):
            if not _is_vowel(w, i) and _is_vowel(w, i - 1):
                r1 = i + 1
                break
    r2 = len(w)
    for i in range(r1 + 1, len(w)):
        if not _is_vowel(w, i) and _is_vowel(w, i - 1):
            r2 = i + 1
            break
    return r1, r2


def _ends_short_syllable(w: str) -> bool:
    if len(w) == 2:
        return _is_vowel(w, 0) and not _is_vowel(w, 1)
    if len(w) >= 3:
        # vowel preceded by non-vowel, followed by non-vowel other than w/x/Y
        return (
            _is_vowel(w, len(w) - 2)
            and not _is_vowel(w, len(w) - 3)
            and not _is_vowel(w, len(w) - 1)
            and w[-1] not in "wxY"
        )
    return False


def _is_short(w: str, r1: int) -> bool:
    return r1 >= len(w) and _ends_short_syllable(w)


def snowball_stem(word: str) -> str:
    # Official ordering (english.sbl): exception1 → length gate → prelude
    # (apostrophe strip + y marking) → regions → steps.
    w = word.lower()
    if w in _EXCEPTIONS:
        return _EXCEPTIONS[w]
    if len(w) <= 2:
        return w
    if w.startswith("\x27"):
        w = w[1:]

    # Mark consonant-y as Y.
    if w[0] == "y":
        w = "Y" + w[1:]
    chars = list(w)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    w = "".join(chars)

    r1, r2 = _regions(w)

    # Step 0: strip 's' / 's / '
    for suf in ("'s'", "'s", "'"):
        if w.endswith(suf):
            w = w[: -len(suf)]
            break

    # Step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith(("ied", "ies")):
        w = w[:-2] if len(w) > 4 else w[:-1]
    elif w.endswith(("us", "ss")):
        pass
    elif w.endswith("s"):
        if any(c in _VOWELS for c in w[:-2]):
            w = w[:-1]

    if w in _EXCEPTIONS_POST_1A:
        return w.replace("Y", "y")

    # Step 1b
    if w.endswith(("eedly", "eed")):
        suf = "eedly" if w.endswith("eedly") else "eed"
        if len(w) - len(suf) >= r1:
            w = w[: -len(suf)] + "ee"
    else:
        for suf in ("ingly", "edly", "ing", "ed"):
            if w.endswith(suf):
                stem = w[: -len(suf)]
                if any(c in _VOWELS for c in stem):
                    w = stem
                    if w.endswith(("at", "bl", "iz")):
                        w += "e"
                    elif w.endswith(_DOUBLES):
                        w = w[:-1]
                    elif _is_short(w, r1):
                        w += "e"
                break

    # Step 1c
    if (
        len(w) > 2
        and w[-1] in "yY"
        and w[-2] not in _VOWELS
    ):
        w = w[:-1] + "i"

    # Step 2 (conditions in R1)
    for suf, rep in _STEP2:
        if w.endswith(suf):
            if len(w) - len(suf) >= r1:
                if suf == "ogi":
                    if w.endswith("logi"):
                        w = w[:-1]
                elif suf == "li":
                    if len(w) >= 3 and w[-3] in _LI_VALID:
                        w = w[:-2]
                else:
                    w = w[: -len(suf)] + rep
            break

    # Step 3 (conditions in R1; 'ative' requires R2)
    for suf, rep in _STEP3:
        if w.endswith(suf):
            if len(w) - len(suf) >= r1:
                if suf == "ative":
                    if len(w) - len(suf) >= r2:
                        w = w[: -len(suf)]
                else:
                    w = w[: -len(suf)] + rep
            break

    # Step 4 (conditions in R2)
    for suf in _STEP4:
        if w.endswith(suf):
            if len(w) - len(suf) >= r2:
                if suf == "ion":
                    if len(w) >= 4 and w[-4] in "st":
                        w = w[:-3]
                else:
                    w = w[: -len(suf)]
            break

    # Step 5
    if w.endswith("e"):
        stem = w[:-1]
        if len(stem) >= r2 or (len(stem) >= r1 and not _ends_short_syllable(stem)):
            w = stem
    elif w.endswith("ll") and len(w) - 1 >= r2:
        w = w[:-1]

    return w.replace("Y", "y")
