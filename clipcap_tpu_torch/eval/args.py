"""Eval CLI args — flag parity with
ClipCap's clipcap/eval/args.py:3-31, plus ``--predictions-json``
(generalizing the reference's hardcoded ``eval2.json``, eval/base.py:79-80:
pass it to score precomputed predictions instead of running generation)."""
from argparse import ArgumentParser


def add_eval_args(parser: ArgumentParser) -> ArgumentParser:
    ev = parser.add_argument_group("eval")
    ev.add_argument(
        "--reference-csv", type=str, default="./eval.csv",
        help="Path to csv filled with reference captions.",
    )
    ev.add_argument(
        "--csv-filename-column", type=str, default="file_name",
        help="Column containing filenames in the csv.",
    )
    ev.add_argument(
        "--csv-reference-caption-columns", type=str,
        default="caption_reference_{00..05}",
        help="Column(s) containing the ground truth captions (brace expandable).",
    )
    ev.add_argument(
        "--save-file", type=str, default=None,
        help="Path to json file to dump eval metrics to (optional).",
    )
    ev.add_argument(
        "--predictions-json", type=str, default=None,
        help="Optional {filename: caption} json of precomputed predictions; "
             "skips generation (the reference's eval2.json behavior, made a flag).",
    )
    ev.add_argument(
        "--save-predictions", type=str, default=None,
        help="Optional path to dump generated {filename: caption} json.",
    )
    ev.add_argument(
        "--fp-precision", type=int, default=32,
        help="Generation compute precision: 16 = bfloat16 (≈2x faster decode), "
             "32 = float32 (reference-faithful).",
    )
    ev.add_argument(
        "--allow-fallback-tokenizer", action="store_true",
        help="Proceed even when only the byte-level fallback tokenizer is "
             "available (no GPT-2 vocab files; run clipcap-init to fetch "
             "them). Generated token ids then do NOT match a pretrained "
             "GPT-2, so scores against real references are meaningless — "
             "eval refuses by default instead of reporting them silently.",
    )
    ev.add_argument(
        "--eval-batch-size", type=int, default=32,
        help="Samples per device batch during generation (the whole "
             "encoder->mapper->decode chain runs batched; the reference "
             "evaluates one sample at a time).",
    )
    return parser
