"""Argparse helpers.

The port's own copy of ``clipcap_tpu/utils/argtypes.py``.  The reference
uses ``type=bool`` on flags (its train and model args), which parses
ANY provided string — including "false" — as True (documented bug,
SURVEY.md §"bugs").  ``str2bool`` keeps the same ``--flag value`` CLI shape
but actually parses the value.
"""
from __future__ import annotations

from argparse import ArgumentTypeError


def str2bool(value) -> bool:
    if isinstance(value, bool):
        return value
    v = str(value).strip().lower()
    if v in ("yes", "true", "t", "y", "1"):
        return True
    if v in ("no", "false", "f", "n", "0", ""):
        return False
    raise ArgumentTypeError(f"boolean value expected, got '{value}'")
