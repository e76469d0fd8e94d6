"""Length-normalised beam search with the reference's semantics.

Counterpart of ``clipcap_tpu/inference/beam.py``, token for token:

* first step: top-k over the log-softmax of the temperature-scaled logits
  expands each prefix to ``beam_size`` beams;
* later steps: a stopped beam offers one continuation, token 0 at additive
  score 0; live beams grow by one; candidates rank by ``score_sum /
  seq_length`` over the beam·vocab table, ties broken by the lower flat
  index; the stored score is the unnormalised ``avg · seq_length``;
* stop on the EOS token; final ranking by ``score / seq_length``.

The KV cache never moves: a ``[B, T]`` ancestry table records which row
holds each beam's K/V per position and attention selects through it
(``models/gpt2.py``).  Only tokens, scores and lengths are gathered.  The
prefix K/V is stored once per sample at the head of the beam cache (the
folded prefix, the default) or replicated per beam (``fold_prefix=False``).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from clipcap_tpu_torch.models.gpt2 import (GPT2, gpt2_apply, gpt2_embed_tokens,
                                           init_kv_cache, lm_logits)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BeamParams:
    beam_size: int = 5
    max_new_tokens: int = 67
    temperature: float = 1.0
    stop_token: int = 50256
    pad_token: int = 0
    int8_kv: bool = False          # not ported (ROADMAP.md, queue B)
    consolidate_every: int = 0     # not ported (ROADMAP.md, queue B)
    fold_prefix: bool = True


class BeamResult(NamedTuple):
    tokens: Tensor       # [..., beam, max_new_tokens] int64 (includes the stop token)
    seq_lengths: Tensor  # [..., beam] float32 (counts the stop token)
    scores: Tensor       # [..., beam] float32, length-normalised


def _rank(avg: Tensor, flat_ids: Tensor, K: int):
    """The top K of each row by (avg desc, flat id asc) → (avg, flat id)."""
    by_id = torch.argsort(flat_ids, dim=1, stable=True)
    avg, flat_ids = avg.gather(1, by_id), flat_ids.gather(1, by_id)
    order = torch.argsort(-avg, dim=1, stable=True)[:, :K]
    return avg.gather(1, order), flat_ids.gather(1, order)


@torch.no_grad()
def beam_search_batched(lm: GPT2, prefix_embeds: Tensor, bp: BeamParams,
                        dtype=torch.bfloat16) -> BeamResult:
    """R independent beam searches over ``prefix_embeds`` [R, P, D], batched
    into one decode loop."""
    if bp.int8_kv or bp.consolidate_every > 0:
        raise NotImplementedError("int8 KV cache and converged-prefix consolidation are "
                                  "not ported yet (ROADMAP.md, queue B)")
    R, P, D = prefix_embeds.shape
    K, N = bp.beam_size, bp.max_new_tokens
    B = R * K
    t = bp.temperature if bp.temperature > 0 else 1.0
    dev = prefix_embeds.device
    pe = prefix_embeds.to(dtype)

    if bp.fold_prefix:
        # The prefix K/V is identical across beams: one beam_size-free
        # prefill writes it once, into slots [0, P) of the beam cache.
        cache = init_kv_cache(lm.config, B, N, dtype=dtype, beam_size=K, prefix_slots=P,
                              device=dev)
        hidden0, cache = gpt2_apply(lm, inputs_embeds=pe, kv_cache=cache, cache_index=0,
                                    dtype=dtype, return_logits=False)
        h_last = hidden0[:, -1]
        anc_len, base = N, P
    else:
        cache = init_kv_cache(lm.config, B, P + N, dtype=dtype, beam_size=K, device=dev)
        hidden0, cache = gpt2_apply(lm, inputs_embeds=pe.repeat_interleave(K, dim=0),
                                    kv_cache=cache, cache_index=0, dtype=dtype,
                                    beam_size=K, return_logits=False)
        h_last = hidden0.reshape(R, K, P, -1)[:, 0, -1]
        anc_len, base = P + N, 0
    logp0 = torch.log_softmax(lm_logits(lm, h_last).float() / t, dim=-1)   # [R, V]
    V = logp0.shape[-1]
    scores, first = torch.topk(logp0, K, dim=-1)                          # [R, K]

    tokens = torch.full((R, K, N), bp.pad_token, dtype=torch.long, device=dev)
    tokens[:, :, 0] = first
    seq_lengths = torch.ones((R, K), dtype=torch.float32, device=dev)
    stopped = first == bp.stop_token
    own_row = torch.arange(B, device=dev) % K
    ancestry = own_row[:, None].repeat(1, anc_len)                        # [B, anc_len]
    filler = torch.arange(K, device=dev)[None, None, :]
    frozen = torch.where(filler == 0, 0.0, float("-inf"))
    beam_ids = torch.arange(K, device=dev)[None, :, None] * V

    for step in range(1, N):
        if bool(stopped.all()):
            break
        # Forward the tokens chosen at step-1 (position P + step - 1); each
        # beam writes its own row, so its ancestry there is its own row.
        pos = P + step - 1
        ancestry[:, pos - base] = own_row
        emb = gpt2_embed_tokens(lm, tokens[:, :, step - 1].reshape(B, 1), dtype)
        step_logits, cache = gpt2_apply(lm, inputs_embeds=emb, kv_cache=cache,
                                        cache_index=pos, dtype=dtype, beam_size=K,
                                        ancestry=ancestry, cache_base=base)
        # Within a beam row, avg order == logit order, so every joint top-K
        # winner is in its row's top K: rank only those K·K candidates.
        l = step_logits[:, 0]                                             # [B, V]
        top_l, top_v = torch.topk(l, K, dim=-1)
        lse = torch.logsumexp(l.float() / t, dim=-1)
        logp_cand = (top_l.float() / t - lse[:, None]).reshape(R, K, K)
        cand_ids = top_v.reshape(R, K, K)
        # Stopped beams: only token 0 with additive score 0.
        logp_cand = torch.where(stopped[:, :, None], frozen, logp_cand)
        cand_ids = torch.where(stopped[:, :, None], filler, cand_ids)

        seq_lengths = seq_lengths + (~stopped).float()
        avg = (scores[:, :, None] + logp_cand) / seq_lengths[:, :, None]
        top_avg, flat_idx = _rank(avg.reshape(R, K * K),
                                  (beam_ids + cand_ids).reshape(R, K * K), K)
        src = flat_idx // V                                               # [R, K]
        next_tok = flat_idx % V

        tokens = tokens.gather(1, src[:, :, None].expand(R, K, N))
        tokens[:, :, step] = next_tok
        seq_lengths = seq_lengths.gather(1, src)
        stopped = stopped.gather(1, src)
        scores = top_avg * seq_lengths
        ancestry = ancestry.reshape(R, K, anc_len).gather(
            1, src[:, :, None].expand(R, K, anc_len)).reshape(B, anc_len)
        stopped = stopped | (next_tok == bp.stop_token)

    return BeamResult(tokens=tokens, seq_lengths=seq_lengths, scores=scores / seq_lengths)


def beam_search(lm: GPT2, prefix_embeds: Tensor, bp: BeamParams,
                dtype=torch.bfloat16) -> BeamResult:
    """Single-sample beam search: ``prefix_embeds`` [1, P, D]."""
    res = beam_search_batched(lm, prefix_embeds, bp, dtype=dtype)
    return BeamResult(tokens=res.tokens[0], seq_lengths=res.seq_lengths[0],
                      scores=res.scores[0])
