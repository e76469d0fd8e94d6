"""Beam-search captioning with a LongCat-Flash language model: images →
CLIP tower → mapper → ``beam_search_batched`` over LongCat-Flash-Chat,
holding one chip's share of its FFN experts.

The unit and the check are ``caption_kimi.py``'s (its ``Cell``: the
caption unit, ``embed_rel``, ``prefix_rel``, ``score_err``, ``rank_gap``),
with the language model, its seeded weights (``weights_longcat.py``) and
its plain reference (``reference/longcat_flash.py``: float32, the double
layer with the shortcut MoE as published, un-absorbed latent attention
over full keys and values, the router over all 768 outputs, the held FFN
experts looped over and the identity experts' part, the weights held in
bf16 and upcast at each use) in Kimi-Linear's.  The reference holds the
program's seeded bf16 weights (55.9 GB; 111.8 GB in float32 would not fit
the card) and upcasts one matrix at a time, so at most one double layer's
worth of float32 is live.  The configuration file holds the model's
``config.json`` keys at its top level, ``n_routed_experts`` the FFN
experts held here (``experts_held`` of ``n_routed_experts_published``).

The model's module is imported here, at the top, so a tree without it
fails at once.
"""
from __future__ import annotations

import gc

import torch

from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.models.longcat_flash import LongcatFlash, longcat_config_from_hf

from portbench import program, weights_longcat
from portbench.kinds import caption_kimi, common
from portbench.reference.longcat_flash import lm_logits, longcat_hidden, token_embeds
from portbench.reference.numerics import Numerics

ITEM = "captions"


def model_config(cfg: dict) -> dict:
    """The model's ``config.json`` keys as published (``n_routed_experts``
    the router's FFN experts) and the experts held here."""
    return dict(cfg, n_routed_experts=cfg["n_routed_experts_published"],
                experts_held=list(cfg["experts_held"]))


def language_model(cfg: dict, seed: int, device, dtype) -> LongcatFlash:
    """The port's model, built on the meta device, holding the seeded
    weights made on ``device``."""
    with torch.device("meta"):
        lm = LongcatFlash(longcat_config_from_hf(model_config(cfg), tuple(cfg["experts_held"]),
                                                 name=cfg["name"]))
    return program._assign(lm, weights_longcat.longcat(cfg, seed, device, dtype))


class Cell(caption_kimi.Cell):
    def __init__(self, cfg: dict, traffic: dict, spec: dict, seed: int, device):
        """``caption_kimi.Cell``'s, building this module's language model
        (the constructor's one call of ``caption_kimi.language_model``,
        taken for the block)."""
        with common.patched(caption_kimi, "language_model", language_model):
            super().__init__(cfg, traffic, spec, seed, device)

    def spans(self):
        """Spans around the prefill and each decode step (the calls of
        ``longcat_apply`` that beam search makes), counting the steps."""
        def longcat_apply(*args, **kwargs):
            decode = kwargs.get("ancestry") is not None
            self.decode_steps += decode
            with torch.profiler.record_function("pb:decode_step" if decode else "pb:prefill"):
                return orig(*args, **kwargs)

        orig = beam_mod.longcat_apply
        return common.patched(beam_mod, "longcat_apply", longcat_apply)

    def release(self) -> None:
        """``caption.Cell.release``, then the freed blocks handed back to the
        device: the decode graphs' pools are only freed with the model's
        reference cycles, and the reference's 55.9 GB of bf16 weights are
        made as one tensor, which the caching allocator's ~46 GiB of
        reserved blocks would not leave room for."""
        super().release()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self, modes=("fp32",)) -> dict:
        """``caption_kimi.Cell.readings``, the reference holding this
        model's seeded weights (the reading's one call of
        ``weights_kimi.kimi``, taken for the block)."""
        with common.patched(caption_kimi.weights_kimi, "kimi", weights_longcat.longcat):
            return super().readings(modes)

    def _logp(self, Wlm: dict, prefix, tokens, num: Numerics):
        """Log-probabilities of every position's next token for the K beams
        of one image: the reference over the prefix and the served tokens
        (all but the last), rows P-1 .. P+N-2."""
        K, N = tokens.shape
        P = prefix.shape[0]
        x = torch.cat([prefix[None].expand(K, -1, -1), token_embeds(Wlm, tokens[:, :-1])], 1)
        h = longcat_hidden(Wlm, x, model_config(self.cfg), num)[:, P - 1:]
        return torch.log_softmax(lm_logits(Wlm, h, num), dim=-1)
