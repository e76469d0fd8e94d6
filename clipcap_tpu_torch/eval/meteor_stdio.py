"""meteor-1.5.jar ``-stdio`` line-protocol server.

The reference drives METEOR through a persistent subprocess speaking a
two-verb line protocol (ClipCap's clipcap/eval/pycocoevalcap/meteor/
meteor.py:21-63):

    SCORE ||| ref 1 words ||| ... ||| ref n words ||| hypothesis words
        → one line of sufficient statistics
    EVAL ||| stats 1 ||| stats 2 ||| ... ||| stats n
        → n per-segment score lines, then ONE aggregate score line
          (the score of the summed statistics)

This module serves that exact protocol over stdin/stdout on top of the
framework's METEOR scorer (C++ core when built, Python otherwise), so the
reference's own ``Meteor`` driver class — or any other coco-caption fork —
can point its command line at ``clipcap-meteor`` instead of
``java -jar meteor-1.5.jar`` and work unchanged.  Jar-style positional
arguments (``- - -stdio -l en -norm -a <table>``) are accepted: ``-a``
selects the paraphrase table, everything else matches the defaults this
scorer already implements (English, -norm preprocessing).

The statistics line is OPAQUE to the driver (it only echoes it back into
EVAL), so it carries this scorer's 7 sufficient statistics
(``matches_h matches_r chunks w_matched_h w_matched_r w_len_h w_len_r`` —
the same order as ``native/src/meteor.cpp::ccn_meteor_stats``) rather than
the jar's internal 23-field format; the SCORE → EVAL round trip is what the
protocol guarantees, and it is preserved exactly.

For SCORE with multiple references the emitted statistics are those of the
best-scoring reference — the same selection ``compute_score`` applies —
so EVAL aggregation matches the in-process corpus score bit for bit.
"""
from __future__ import annotations

import sys
from typing import IO, List, Optional, Sequence

from clipcap_tpu_torch.eval.meteor import get_meteor

_SEP = "|||"


def _fmt(values: Sequence[float]) -> str:
    # repr round-trips doubles exactly; ints print without the trailing .0
    # purely for readability (float("3") == 3.0 either way).
    out = []
    for v in values:
        out.append(str(int(v)) if float(v).is_integer() else repr(float(v)))
    return " ".join(out)


def _best_stats(scorer, hyp: str, refs: Sequence[str]) -> List[float]:
    best_score, best = 0.0, None
    for ref in refs:
        st = scorer.segment_stats(hyp, ref)
        sc = scorer.score_from_stats(st)
        if best is None or sc > best_score:
            best_score, best = sc, st
    if best is None:  # no references — empty stats score 0
        best = scorer.segment_stats(hyp, "")
    return list(best)


def serve(in_stream: IO[str], out_stream: IO[str], scorer=None) -> None:
    """Serve the SCORE/EVAL protocol until EOF.  Blank lines are ignored;
    a malformed verb raises (matching the jar's fail-loud behavior)."""
    if scorer is None:
        scorer = get_meteor()
    for raw in in_stream:
        line = raw.strip()
        if not line:
            continue
        parts = [p.strip() for p in line.split(_SEP)]
        verb = parts[0]
        if verb == "SCORE":
            if len(parts) < 3:
                raise ValueError(f"SCORE needs >=1 reference + hypothesis: {line!r}")
            *refs, hyp = parts[1:]
            out_stream.write(_fmt(_best_stats(scorer, hyp, refs)) + "\n")
        elif verb == "EVAL":
            blocks = [[float(x) for x in p.split()] for p in parts[1:] if p]
            agg: Optional[List[float]] = None
            for st in blocks:
                out_stream.write(repr(scorer.score_from_stats(st)) + "\n")
                agg = st if agg is None else [a + b for a, b in zip(agg, st)]
            final = scorer.score_from_stats(agg) if agg else 0.0
            out_stream.write(repr(final) + "\n")
        else:
            raise ValueError(f"unknown METEOR protocol verb: {verb!r}")
        out_stream.flush()


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI entry (``clipcap-meteor``).  Accepts the jar's argv — e.g.
    ``clipcap-meteor - - -stdio -l en -norm -a data/paraphrase-en.gz`` —
    plus ``--function-words PATH`` / ``--synonyms SYNSETS[,EXCEPTIONS]``."""
    args = list(sys.argv[1:] if argv is None else argv)
    paraphrase = None
    function_words = None
    synonyms = None
    i = 0
    while i < len(args):
        a = args[i]
        if a == "-a":
            i += 1
            paraphrase = args[i]
        elif a == "--function-words":
            i += 1
            function_words = args[i]
        elif a == "--synonyms":
            i += 1
            paths = args[i].split(",")
            synonyms = (paths[0], paths[1] if len(paths) > 1 else None)
        elif a in ("-", "-stdio", "-norm", "-noPunct", "-lower"):
            pass  # jar-compatible no-ops (behavior is already the default)
        elif a == "-l":
            i += 1
            if args[i] != "en":
                raise SystemExit("only -l en is supported")
        else:
            raise SystemExit(f"unknown argument: {a}")
        i += 1
    scorer = get_meteor(paraphrase_path=paraphrase,
                        synonym_paths=synonyms,
                        function_words_path=function_words)
    serve(sys.stdin, sys.stdout, scorer)


if __name__ == "__main__":
    main()
