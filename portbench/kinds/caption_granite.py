"""Beam-search captioning with a Granite-4.0-H language model: images → CLIP
tower → mapper → ``beam_search_batched`` over Granite-4.0-H-Small, holding
one chip's share of its experts.

The unit and the check are ``caption_kimi.py``'s (its ``Cell``: the
caption unit, ``embed_rel``, ``prefix_rel``, ``score_err``, ``rank_gap``),
with the language model, its seeded weights (``weights_granite.py``) and
its plain reference (``reference/granite_hybrid.py``: float32, the Mamba-2
recurrence token by token from a zero state, full causal GQA, the held
experts looped over with the same routing, the multipliers and the tied
head, the weights held in bf16 and upcast at each use) in Kimi-Linear's.
The configuration file holds the model's ``config.json`` keys at its top
level, ``num_local_experts`` the experts held here (``experts_held`` of
``num_local_experts_published``).

The model's module is imported here, at the top, so a tree without it
fails at once.
"""
from __future__ import annotations

import torch

from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.models.granite_hybrid import GraniteHybrid, granite_config_from_hf

from portbench import program, weights_granite
from portbench.kinds import caption_kimi, common
from portbench.reference.granite_hybrid import granite_hidden, lm_logits, token_embeds
from portbench.reference.numerics import Numerics

ITEM = "captions"


def model_config(cfg: dict) -> dict:
    """The model's ``config.json`` keys as published (``num_local_experts``
    the router's width) and the experts held here."""
    return dict(cfg, num_local_experts=cfg["num_local_experts_published"],
                experts_held=list(cfg["experts_held"]))


def language_model(cfg: dict, seed: int, device, dtype) -> GraniteHybrid:
    """The port's model, built on the meta device, holding the seeded
    weights made on ``device``."""
    with torch.device("meta"):
        lm = GraniteHybrid(granite_config_from_hf(model_config(cfg), tuple(cfg["experts_held"]),
                                                  name=cfg["name"]))
    return program._assign(lm, weights_granite.granite(cfg, seed, device, dtype))


class Cell(caption_kimi.Cell):
    def __init__(self, cfg: dict, traffic: dict, spec: dict, seed: int, device):
        """``caption_kimi.Cell``'s, building this module's language model
        (the constructor's one call of ``caption_kimi.language_model``,
        taken for the block)."""
        with common.patched(caption_kimi, "language_model", language_model):
            super().__init__(cfg, traffic, spec, seed, device)

    def spans(self):
        """Spans around the prefill and each decode step (the calls of
        ``granite_apply`` that beam search makes), counting the steps."""
        def granite_apply(*args, **kwargs):
            decode = kwargs.get("ancestry") is not None
            self.decode_steps += decode
            with torch.profiler.record_function("pb:decode_step" if decode else "pb:prefill"):
                return orig(*args, **kwargs)

        orig = beam_mod.granite_apply
        return common.patched(beam_mod, "granite_apply", granite_apply)

    def readings(self, modes=("fp32",)) -> dict:
        """``caption_kimi.Cell.readings``, the reference holding this
        model's seeded weights (the reading's one call of
        ``weights_kimi.kimi``, taken for the block)."""
        with common.patched(caption_kimi.weights_kimi, "kimi", weights_granite.granite):
            return super().readings(modes)

    def _logp(self, Wlm: dict, prefix, tokens, num: Numerics):
        """Log-probabilities of every position's next token for the K beams
        of one image: the reference over the prefix and the served tokens
        (all but the last), rows P-1 .. P+N-2."""
        K, N = tokens.shape
        P = prefix.shape[0]
        c = model_config(self.cfg)
        x = torch.cat([prefix[None].expand(K, -1, -1), token_embeds(Wlm, tokens[:, :-1])], 1)
        h = granite_hidden(Wlm, x, c, num)[:, P - 1:]
        return torch.log_softmax(lm_logits(Wlm, h, num, c), dim=-1)
