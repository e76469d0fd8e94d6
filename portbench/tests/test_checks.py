"""The check that decides ``correct``, on tiny cells on the CPU.

Run from the root of the checkout: ``python -m pytest portbench/tests -q``.
Each cell's kind runs through the harness with the full cell's limits
(``workloads/<cell>.json``):

* a sound run comes out correct;
* the control (the reference in float8 in the program's place) reads
  above a limit;
* the timed path broken underneath (a token or an answer altered where
  it is produced, an optimizer step that leaves the state unchanged, a
  loss that takes the mean over half of the batch) comes out not correct.
"""
from unittest import mock

import pytest
import torch

from conftest import CELLS, run_tiny, tiny_files

from clipcap_tpu_torch.encoders import clip as clip_mod
from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.train import state as state_mod
from clipcap_tpu_torch.train import step as step_mod

from portbench import harness


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_sound_run_is_correct(kind):
    result = run_tiny(kind)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("kind", sorted(CELLS))
def test_control_fails_a_limit(kind):
    files = tiny_files(kind)
    cell = files.kind.Cell(files.cfg, files.traffic, files.spec, 987654321, torch.device("cpu"))
    cell.warmup()
    harness.window(cell, 0.0)
    cell.release()
    readings = cell.readings(modes=("fp32", "fp8"))
    over = {k: readings[f"ctrl.{k}"] for k, limit in files.spec["limits"].items()
            if readings[f"ctrl.{k}"] > limit}
    assert over, {k: readings[f"ctrl.{k}"] for k in files.spec["limits"]}


def _altered_tokens(orig):
    def beam_search_batched(*args, **kwargs):
        res = orig(*args, **kwargs)
        tokens = res.tokens.clone()
        tokens[..., 2] = (tokens[..., 2] + 1) % 50000
        return res._replace(tokens=tokens)
    return beam_search_batched


def _altered_answers(orig):
    def __call__(self, batch):
        return orig(self, batch)[::-1].copy()
    return __call__


def _half_batch(orig):
    def clipcap_loss(model, tokens, embeddings, **kwargs):
        half = tokens.shape[0] // 2
        return orig(model, tokens[:half], embeddings[:half], **kwargs)
    return clipcap_loss


FAULTS = {
    "caption.token_altered": ("caption", beam_mod, "beam_search_batched", _altered_tokens),
    "embed.answer_altered": ("embed", clip_mod.CLIPEncoder, "__call__", _altered_answers),
    "train.state_unchanged": ("train", state_mod, "fused_adamw", lambda orig: lambda *a: None),
    "train.half_batch": ("train", step_mod, "clipcap_loss", _half_batch),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_path_is_not_correct(fault):
    kind, owner, attr, make = FAULTS[fault]
    with mock.patch.object(owner, attr, make(getattr(owner, attr))):
        result = run_tiny(kind)
    assert result["correct"] is False, result["checks"]
