"""Beam-search captioning with a Kimi-Linear language model: images → CLIP
tower → mapper → ``beam_search_batched`` over Kimi-Linear-48B-A3B, holding
one chip's share of its experts.

The unit and the check are ``caption.py``'s (``Cell``'s ``run``,
``sample``, ``work``; ``embed_rel``, ``prefix_rel``, ``score_err``,
``rank_gap``), with the language model, its seeded weights
(``weights_kimi.py``) and its plain reference (``reference/kimi_linear.py``:
float32, the KDA recurrence token by token from a zero state, the held
experts looped over with the same routing, the weights held in bf16 and
upcast at each use) in GPT-2's place.  The configuration file holds the
model's ``config.json`` keys at its top level, ``num_experts`` the experts
held here (``experts_held`` of ``num_experts_published``).

The model's module is imported here, at the top, so a tree without it
fails at once.
"""
from __future__ import annotations

import numpy as np
import torch

from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.inference.beam import BeamParams
from clipcap_tpu_torch.models.kimi_linear import KimiLinear, kimi_config_from_hf

from portbench import program, weights, weights_kimi
from portbench.kinds import caption, common
from portbench.reference.clip_vit import vit_encode
from portbench.reference.kimi_linear import kimi_hidden, lm_logits, token_embeds
from portbench.reference.mapper import mapper_prefix
from portbench.reference.numerics import Numerics, fp32
from portbench.traffic import generate

ITEM = "captions"


def model_config(cfg: dict) -> dict:
    """The model's ``config.json`` keys as published (``num_experts`` the
    router's width) and the experts held here."""
    return dict(cfg, num_experts=cfg["num_experts_published"],
                experts_held=list(cfg["experts_held"]))


def language_model(cfg: dict, seed: int, device, dtype) -> KimiLinear:
    """The port's model, built on the meta device, holding the seeded
    weights made on ``device``."""
    with torch.device("meta"):
        lm = KimiLinear(kimi_config_from_hf(model_config(cfg), tuple(cfg["experts_held"]),
                                            name=cfg["name"]))
    return program._assign(lm, weights_kimi.kimi(cfg, seed, device, dtype))


class Cell(caption.Cell):
    def __init__(self, cfg: dict, traffic: dict, spec: dict, seed: int, device):
        self.cfg, self.traffic, self.spec, self.seed, self.device = cfg, traffic, spec, seed, device
        self.dtype = program.DTYPES[cfg["dtype"]]
        self.encoder = program.image_encoder(cfg, seed, device, self.dtype)
        self.mapper = program.mapper(cfg, seed, device, self.dtype)
        self.lm = language_model(cfg, seed, device, self.dtype)
        self.bp = BeamParams(beam_size=traffic["beam_size"],
                             max_new_tokens=traffic["max_new_tokens"],
                             temperature=traffic["temperature"], stop_token=cfg["eos_token_id"],
                             int8_kv=traffic["int8_kv"],
                             consolidate_every=traffic["consolidate_every"],
                             tile_major=traffic["tile_major"])
        self.images = generate.images(traffic, cfg["encoder"]["image_size"], seed, device)
        self.items_per_unit = traffic["batch"]
        self.last = {}
        self.decode_steps = 0

    def spans(self):
        """Spans around the prefill and each decode step (the calls of
        ``kimi_apply`` that beam search makes), counting the steps."""
        def kimi_apply(*args, **kwargs):
            decode = kwargs.get("ancestry") is not None
            self.decode_steps += decode
            with torch.profiler.record_function("pb:decode_step" if decode else "pb:prefill"):
                return orig(*args, **kwargs)

        orig = beam_mod.kimi_apply
        return common.patched(beam_mod, "kimi_apply", kimi_apply)

    def readings(self, modes=("fp32",)) -> dict:
        """As ``caption.Cell.readings``, against the Kimi-Linear reference."""
        dev, cfg = self.device, self.cfg
        K = self.traffic["beam_size"]
        picks = self.sample()
        imgs = torch.as_tensor(np.stack([self.images[j][r] for j, r in picks]), device=dev)
        emb_p = torch.as_tensor(np.stack([self.last[j][0][r] for j, r in picks]), device=dev)
        pre_p = torch.stack([self.last[j][1][r] for j, r in picks]).float()
        toks = torch.stack([self.last[j][2][r] for j, r in picks]).to(dev)        # [n, K, N]
        lens = torch.stack([self.last[j][3][r] for j, r in picks]).to(dev).long()  # [n, K]
        score_p = torch.stack([self.last[j][4][r] for j, r in picks]).to(dev)
        valid = torch.arange(toks.shape[-1], device=dev)[None, None] < lens[..., None]
        ref = Numerics("fp32")
        out = {}
        with torch.no_grad(), fp32():
            Wc = {k: v.float() for k, v in weights.clip_visual(cfg, self.seed, dev,
                                                               self.dtype).items()}
            Wm = {k: v.float() for k, v in weights.mapper(cfg, self.seed, dev, self.dtype).items()}
            Wlm = weights_kimi.kimi(cfg, self.seed, dev, self.dtype)   # upcast at each use
            e_ref = common.blocks(lambda x: vit_encode(Wc, x, cfg["encoder"], ref), imgs, 32)
            for mode in modes:
                num = Numerics(mode)
                if mode == "fp32":
                    emb, pre = emb_p, pre_p
                else:
                    emb = common.blocks(lambda x: vit_encode(Wc, x, cfg["encoder"], num), imgs, 32)
                    pre = mapper_prefix(Wm, emb, cfg["mapper"], num)
                pre_ref = mapper_prefix(Wm, emb, cfg["mapper"], ref)
                tag = "" if mode == "fp32" else "ctrl."
                out[tag + "embed_rel"] = common.worst_rel(emb, e_ref)
                out[tag + "prefix_rel"] = common.worst_rel(pre, pre_ref)
                gap, err = [], []
                for n in range(len(picks)):
                    logp_ref = self._logp(Wlm, pre[n], toks[n], ref)                 # [K, N, V]
                    kth = logp_ref.topk(K, dim=-1).values[..., -1]                   # [K, N]
                    served_ref = logp_ref.gather(-1, toks[n][..., None])[..., 0]
                    s_ref = (served_ref * valid[n]).sum(-1) / lens[n]
                    if mode == "fp32":
                        err.append((s_ref - score_p[n]).abs().max())
                        g = (kth - served_ref).clamp_min(0) * valid[n]
                    else:
                        logp_c = self._logp(Wlm, pre[n], toks[n], num)
                        s_c = (logp_c.gather(-1, toks[n][..., None])[..., 0]
                               * valid[n]).sum(-1) / lens[n]
                        err.append((s_c - s_ref).abs().max())
                        top_c = logp_c.topk(K, dim=-1).indices                      # [K, N, K]
                        g = (kth[..., None] - logp_ref.gather(-1, top_c)).clamp_min(0)
                        g = g.amax(-1) * valid[n]
                    gap.append(g.max())
                out[tag + "score_err"] = float(torch.stack(err).max())
                out[tag + "rank_gap"] = float(torch.stack(gap).max())
        out["served_tokens"] = int(lens.sum())
        return out

    def _logp(self, Wlm: dict, prefix, tokens, num: Numerics):
        """Log-probabilities of every position's next token for the K beams
        of one image: the reference over the prefix and the served tokens
        (all but the last), rows P-1 .. P+N-2."""
        K, N = tokens.shape
        P = prefix.shape[0]
        x = torch.cat([prefix[None].expand(K, -1, -1), token_embeds(Wlm, tokens[:, :-1])], 1)
        h = kimi_hidden(Wlm, x, model_config(self.cfg), num)[:, P - 1:]
        return torch.log_softmax(lm_logits(Wlm, h, num), dim=-1)
