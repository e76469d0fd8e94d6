"""Finetune stage — ``python -m clipcap_tpu_torch.finetune``.

Counterpart of ``clipcap_tpu/finetune/__init__.py``: the training CLI with
``--train-language-model true`` unless the flag is given, so GPT-2 trains
with the mapper (the train step then recomputes each block in the backward
pass).
"""
from __future__ import annotations

import sys
from typing import List, Optional


def start_finetuning(argv: Optional[List[str]] = None) -> int:
    """``train.train.start_training`` on ``argv`` (default: the command
    line), with ``--train-language-model true`` appended unless present."""
    from clipcap_tpu_torch.train.train import start_training

    argv = list(sys.argv[1:] if argv is None else argv)
    if "--train-language-model" not in " ".join(argv):
        argv += ["--train-language-model", "true"]
    return start_training(argv)
