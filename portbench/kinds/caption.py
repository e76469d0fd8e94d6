"""Beam-search captioning: images → CLIP tower → mapper → GPT-2 beam search.

One unit is one call of the main path on a batch of images staged in host
memory: ``encoders/clip.py::CLIPEncoder`` (host → device copy, the tower,
the embeddings back as numpy, as preprocess and inference hand them on),
``models/mapper.py::mapper_apply`` and ``inference/beam.py::beam_search_batched``,
whose tokens, lengths and scores come back to the host.  The last result of
each distinct batch is kept for the check.

The check, after the window: for a sample of images drawn from the seed
(the one with the longest caption always in it), every beam is compared
with the plain float32 reference layer by layer, each layer fed what the
program fed it:

* ``embed_rel``: the tower's embedding against the reference tower on the
  same uint8 image (relative L2 error, worst image);
* ``prefix_rel``: the mapper's prefix against the reference mapper on the
  program's embedding (relative L2 error, worst image);
* ``score_err``: the beam's length-normalised score against the mean
  log-probability that the reference GPT-2, run over the program's prefix
  and the served tokens, gives those tokens (worst beam);
* ``rank_gap``: how far, in log-probability, a served token lies below the
  reference's K-th best token at its position (every served token is in
  its parent row's top K; worst token, 0 where all are inside).
"""
from __future__ import annotations

import numpy as np
import torch

from clipcap_tpu_torch.inference import beam as beam_mod
from clipcap_tpu_torch.inference.beam import BeamParams
from clipcap_tpu_torch.models.mapper import mapper_apply

from portbench import program, weights
from portbench.kinds import common
from portbench.reference.clip_vit import vit_encode
from portbench.reference.gpt2 import gpt2_hidden, lm_logits, token_embeds
from portbench.reference.mapper import mapper_prefix
from portbench.reference.numerics import Numerics, fp32
from portbench.traffic import generate

ITEM = "captions"


class Cell:
    def __init__(self, cfg: dict, traffic: dict, spec: dict, seed: int, device):
        self.cfg, self.traffic, self.spec, self.seed, self.device = cfg, traffic, spec, seed, device
        self.dtype = program.DTYPES[cfg["dtype"]]
        self.encoder = program.image_encoder(cfg, seed, device, self.dtype)
        self.mapper = program.mapper(cfg, seed, device, self.dtype)
        self.lm = program.language_model(cfg, seed, device, self.dtype)
        self.bp = BeamParams(beam_size=traffic["beam_size"],
                             max_new_tokens=traffic["max_new_tokens"],
                             temperature=traffic["temperature"],
                             stop_token=cfg["language_model"]["eos_token_id"],
                             int8_kv=traffic["int8_kv"],
                             consolidate_every=traffic["consolidate_every"],
                             tile_major=traffic["tile_major"])
        self.images = generate.images(traffic, cfg["encoder"]["image_size"], seed, device)
        self.items_per_unit = traffic["batch"]
        self.last = {}
        self.decode_steps = 0

    def run(self, i: int) -> None:
        j = i % len(self.images)
        emb = self.encoder(self.images[j])
        prefix = mapper_apply(self.mapper, emb, dtype=self.dtype)
        res = beam_mod.beam_search_batched(self.lm, prefix, self.bp, dtype=self.dtype)
        self.last[j] = (emb, prefix, res.tokens.cpu(), res.seq_lengths.cpu(), res.scores.cpu())

    def warmup(self) -> None:
        self.run(0)

    def finish(self) -> None:
        common.sync(self.device)

    # -- tracing ----------------------------------------------------------

    def spans(self):
        """Spans around the prefill and each decode step (the calls of
        ``gpt2_apply`` that beam search makes), counting the steps."""
        def gpt2_apply(*args, **kwargs):
            decode = kwargs.get("ancestry") is not None
            self.decode_steps += decode
            with torch.profiler.record_function("pb:decode_step" if decode else "pb:prefill"):
                return orig(*args, **kwargs)

        orig = beam_mod.gpt2_apply
        return common.patched(beam_mod, "gpt2_apply", gpt2_apply)

    def work(self, units: int) -> dict:
        return {"kind": "caption", "units": units, "batch": self.traffic["batch"],
                "beam_size": self.traffic["beam_size"], "decode_steps": self.decode_steps}

    def release(self) -> None:
        del self.encoder, self.mapper, self.lm

    # -- the check ----------------------------------------------------------

    def sample(self) -> list:
        """(batch, row) pairs: the image with the longest caption, then a
        draw from the seed, ``check_images`` in all."""
        pairs = [(j, r) for j in sorted(self.last) for r in range(self.traffic["batch"])]
        longest = max(pairs, key=lambda p: float(self.last[p[0]][3][p[1]].max()))
        rng = np.random.default_rng(weights.sub_seed(self.seed, "sample"))
        rest = [p for p in pairs if p != longest]
        picks = rng.choice(len(rest), self.spec["check_images"] - 1, replace=False)
        return [longest] + [rest[k] for k in sorted(picks)]

    def readings(self, modes=("fp32",)) -> dict:
        """The compared numbers for the program (``fp32``: against the
        reference) and, for ``fp8``, for the control in its place."""
        dev, cfg = self.device, self.cfg
        K = self.traffic["beam_size"]
        picks = self.sample()
        imgs = torch.as_tensor(np.stack([self.images[j][r] for j, r in picks]), device=dev)
        emb_p = torch.as_tensor(np.stack([self.last[j][0][r] for j, r in picks]), device=dev)
        pre_p = torch.stack([self.last[j][1][r] for j, r in picks]).float()
        toks = torch.stack([self.last[j][2][r] for j, r in picks]).to(dev)        # [n, K, N]
        lens = torch.stack([self.last[j][3][r] for j, r in picks]).to(dev).long()  # [n, K]
        score_p = torch.stack([self.last[j][4][r] for j, r in picks]).to(dev)
        ref = Numerics("fp32")
        out = {}
        with torch.no_grad(), fp32():
            Wc = {k: v.float() for k, v in weights.clip_visual(cfg, self.seed, dev,
                                                               self.dtype).items()}
            Wm = {k: v.float() for k, v in weights.mapper(cfg, self.seed, dev, self.dtype).items()}
            Wlm = {k: v.float() for k, v in weights.gpt2(cfg, self.seed, dev,
                                                         self.dtype).items()}
            e_ref = common.blocks(lambda x: vit_encode(Wc, x, cfg["encoder"], ref), imgs, 32)
            for mode in modes:
                num = Numerics(mode)
                if mode == "fp32":
                    emb, pre, score = emb_p, pre_p, score_p
                else:
                    emb = common.blocks(lambda x: vit_encode(Wc, x, cfg["encoder"], num), imgs, 32)
                    pre = mapper_prefix(Wm, emb, cfg["mapper"], num)
                    score = None
                pre_ref = mapper_prefix(Wm, emb, cfg["mapper"], ref)
                tag = "" if mode == "fp32" else "ctrl."
                out[tag + "embed_rel"] = common.worst_rel(emb, e_ref)
                out[tag + "prefix_rel"] = common.worst_rel(pre, pre_ref)
                gap, err = [], []
                for n in range(len(picks)):
                    logp_ref = self._logp(Wlm, pre[n], toks[n], ref)                 # [K, N, V]
                    kth = logp_ref.topk(K, dim=-1).values[..., -1]                   # [K, N]
                    valid = torch.arange(toks.shape[-1], device=dev)[None] < lens[n][:, None]
                    if mode == "fp32":
                        served = logp_ref.gather(-1, toks[n][..., None])[..., 0]
                        s = (served * valid).sum(-1) / lens[n]
                        err.append((s - score[n]).abs().max())
                        g = (kth - served).clamp_min(0) * valid
                    else:
                        logp_c = self._logp(Wlm, pre[n], toks[n], num)
                        served = logp_c.gather(-1, toks[n][..., None])[..., 0]
                        s_c = (served * valid).sum(-1) / lens[n]
                        s_r = (logp_ref.gather(-1, toks[n][..., None])[..., 0]
                               * valid).sum(-1) / lens[n]
                        err.append((s_c - s_r).abs().max())
                        top_c = logp_c.topk(K, dim=-1).indices                      # [K, N, K]
                        g = (kth[..., None] - logp_ref.gather(-1, top_c)).clamp_min(0)
                        g = g.amax(-1) * valid
                    gap.append(g.max())
                out[tag + "score_err"] = float(torch.stack(err).max())
                out[tag + "rank_gap"] = float(torch.stack(gap).max())
        out["served_tokens"] = int(lens.sum())
        return out

    def _logp(self, Wlm: dict, prefix, tokens, num: Numerics):
        """Log-probabilities of every position's next token for the K beams
        of one image: the reference GPT-2 over the prefix and the served
        tokens (all but the last), rows P-1 .. P+N-2."""
        K, N = tokens.shape
        P = prefix.shape[0]
        x = torch.cat([prefix[None].expand(K, -1, -1), token_embeds(Wlm, tokens[:, :-1])], 1)
        h = gpt2_hidden(Wlm, x, self.cfg["language_model"], num)[:, P - 1:]
        return torch.log_softmax(lm_logits(Wlm, h, num), dim=-1)
