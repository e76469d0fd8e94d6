"""PTB-style tokenization for caption scoring.

The reference shells out to Java
(``edu.stanford.nlp.process.PTBTokenizer -preserveLines -lowerCase`` via
ClipCap's clipcap/eval/pycocoevalcap/tokenizer/ptbtokenizer.py:32-57)
and then strips a fixed punctuation list (:25-26,69-70).  This module is the
native equivalent: the same observable behavior — lowercase, split PTB-style
(contractions, punctuation as separate tokens), drop the punctuation list —
without a JVM.  A C++ implementation with the identical interface lives in
``clipcap_tpu_torch/native`` and is used when built; this Python version is the
always-available fallback and the behavioral spec.
"""
from __future__ import annotations

import re
from typing import Dict, List

# The exact punctuation list the reference wrapper strips
# (ptbtokenizer.py:25-26).  NB the list is UPPERCASE ("-LRB-") but the Java
# tokenizer runs with -lowerCase, which lowercases the bracket escape tokens
# to "-lrb-" — so in the real reference pipeline brackets SURVIVE the strip.
# We reproduce that quirk faithfully (emit lowercase escapes, don't strip).
PUNCTUATIONS = [
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
]
_PUNCT_SET = set(PUNCTUATIONS)

# PTB assimilation splits (PTBLexer splitAssimilations, on by default) —
# the ones that occur in natural caption text.
_ASSIMILATIONS = re.compile(
    r"\b(can)(not)\b|\b(gon|wan)(na)\b|\b(got)(ta)\b|\b(gim|lem)(me)\b"
)


def _split_assimilation(m: re.Match) -> str:
    parts = [g for g in m.groups() if g]
    return " ".join(parts)


_CLITICS = re.compile(r"(?i)('s|'re|'ve|'ll|'d|'m|n't)\b")

# Bracket escapes, emitted LOWERCASE as CoreNLP -lowerCase does.
_BRACKETS = {
    "(": "-lrb-", ")": "-rrb-", "{": "-lcb-", "}": "-rcb-",
    "[": "-lsb-", "]": "-rsb-",
}

# Tokens, in PTB priority order: ellipses, multi-hyphens, clitics,
# numbers with internal [.,:] groups ("3.5", "1,000", "2:30"),
# letter acronyms ("u.s.", "a.m."), words (internal hyphens/apostrophes),
# or single non-space symbols.
_TOKEN = re.compile(
    r"\.\.\.|--|'s|'re|'ve|'ll|'d|'m|n't|"
    r"[0-9]+(?:[.,:][0-9]+)+|"
    r"(?:[a-z]\.){2,}|"
    r"[a-z0-9]+(?:[-'][a-z0-9]+)*|"
    r"[^\sa-z0-9]"
)


def ptb_tokenize_line(line: str) -> List[str]:
    """Tokenize one caption: lowercase → PTB split → strip punctuation."""
    text = line.lower().strip()
    text = _ASSIMILATIONS.sub(_split_assimilation, text)
    # Separate clitics so the word regex picks them apart: "dog's" → "dog 's"
    text = _CLITICS.sub(r" \1", text)
    tokens = []
    for tok in _TOKEN.findall(text):
        tok = _BRACKETS.get(tok, tok)
        if tok in _PUNCT_SET:
            continue
        tokens.append(tok)
    return tokens


class PTBTokenizer:
    """Drop-in equivalent of the reference's Java-bridge tokenizer
    (pycocoevalcap/tokenizer/ptbtokenizer.py): maps
    ``{id: [{"caption": str}, ...]}`` → ``{id: [tokenized_str, ...]}``."""

    def tokenize(self, captions_for_image: Dict) -> Dict:
        out: Dict = {}
        for key, caps in captions_for_image.items():
            out[key] = []
            for cap in caps:
                text = cap["caption"] if isinstance(cap, dict) else cap
                out[key].append(" ".join(ptb_tokenize_line(text)))
        return out


def get_tokenizer() -> PTBTokenizer:
    """Return the native C++ tokenizer when built, else the Python one."""
    try:
        from clipcap_tpu_torch.native import ptb_tokenizer as native

        return native.PTBTokenizer()
    except Exception:
        return PTBTokenizer()


def main() -> None:
    """Line-protocol CLI (``clipcap-ptbtok``): one tokenized line out per
    input line, like the reference's
    ``java edu.stanford.nlp.process.PTBTokenizer -preserveLines -lowerCase``
    subprocess (ptbtokenizer.py:32-57) — with the wrapper's punctuation
    strip (:69-70) already applied, since the two always run together in
    the reference pipeline.  Jar-style flags are accepted and ignored
    (the behavior they select is the default here)."""
    import sys

    try:
        from clipcap_tpu_torch.native.ptb_tokenizer import (
            ptb_tokenize_line as tokenize_line,
        )
    except Exception:
        tokenize_line = ptb_tokenize_line
    for arg in sys.argv[1:]:
        if arg not in ("-preserveLines", "-lowerCase", "-"):
            raise SystemExit(f"unknown argument: {arg}")
    for line in sys.stdin:
        sys.stdout.write(" ".join(tokenize_line(line)) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
