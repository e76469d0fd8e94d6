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

``int8_kv`` stores every cache as int8 rows with per-slot scales.
``consolidate_every`` C > 0 prefills the prefix once per sample into a
shared cache of one slot per position, and every C steps copies there the
generated positions on which all K beams of a sample agree (each sample's
converged length c, a device vector); decode attention then reads the
shared region ``[0, c)`` and the live beam slots past c in one kernel
pass.  The duplicate slots it skips weighed exactly 0, so the tokens equal
C = 0's up to fp summation order.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from clipcap_tpu_torch.models.gpt2 import (GPT2, consolidate_kv_cache, gpt2_apply,
                                           gpt2_embed_tokens, init_kv_cache, init_shared_kv,
                                           lm_logits)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class BeamParams:
    beam_size: int = 5
    max_new_tokens: int = 67
    temperature: float = 1.0
    stop_token: int = 50256
    pad_token: int = 0
    int8_kv: bool = False          # int8 KV cache with per-slot absmax scales
    consolidate_every: int = 0     # consolidate the converged prefix every C steps
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
    R, P, D = prefix_embeds.shape
    K, N, C = bp.beam_size, bp.max_new_tokens, bp.consolidate_every
    B = R * K
    t = bp.temperature if bp.temperature > 0 else 1.0
    dev = prefix_embeds.device
    pe = prefix_embeds.to(dtype)
    cache_kw = dict(dtype=dtype, beam_size=K, int8=bp.int8_kv, device=dev)

    shared = None
    if C > 0:
        # Prefill-to-shared: the prefix runs once per sample straight into
        # the shared cache (slot t = position t); the live beam cache holds
        # the N generated positions from slot 0.
        shared = init_shared_kv(lm.config, R, P + N, dtype=dtype, int8=bp.int8_kv, device=dev)
        hidden0, shared = gpt2_apply(lm, inputs_embeds=pe, kv_cache=shared, cache_index=0,
                                     dtype=dtype, return_logits=False)
        cache = init_kv_cache(lm.config, B, N, **cache_kw)
        h_last = hidden0[:, -1]
        anc_len, base = N, P
    elif bp.fold_prefix:
        # The prefix K/V is identical across beams: one beam_size-free
        # prefill writes it once, into slots [0, P) of the beam cache.
        cache = init_kv_cache(lm.config, B, N, prefix_slots=P, **cache_kw)
        hidden0, cache = gpt2_apply(lm, inputs_embeds=pe, kv_cache=cache, cache_index=0,
                                    dtype=dtype, return_logits=False)
        h_last = hidden0[:, -1]
        anc_len, base = N, P
    else:
        cache = init_kv_cache(lm.config, B, P + N, **cache_kw)
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
    if C > 0:
        # Per-sample converged length: positions [0, c) are in the shared cache.
        c = torch.full((R,), P, dtype=torch.int32, device=dev)
        shared_slots = shared[0][0].shape[2] if bp.int8_kv else shared[0].shape[2]
        t_iota = torch.arange(N + 1, device=dev)[None, :]

    for step in range(1, N):
        if bool(stopped.all()):
            break
        if C > 0 and (step - 1) % C == 0:
            # Every C steps: the leading run of written positions on which
            # all K beams' ancestry agrees moves to the shared cache.  The
            # False sentinel column makes argmin land past a row that agrees
            # everywhere.
            anc3 = ancestry.reshape(R, K, N)
            rows0 = anc3[:, 0]                                        # [R, N]
            conv = torch.cat([(anc3 == rows0[:, None]).all(dim=1),
                              torch.zeros((R, 1), dtype=torch.bool, device=dev)], dim=1)
            conv &= t_iota < step - 1                     # written positions only
            c = torch.maximum(c, P + torch.argmin(conv.to(torch.uint8), dim=1).to(torch.int32))
            rows = torch.nn.functional.pad(rows0, (0, shared_slots - P - N))
            consolidate_kv_cache(cache, shared, rows, K, base=P)
        # Forward the tokens chosen at step-1 (position P + step - 1); each
        # beam writes its own row, so its ancestry there is its own row.
        pos = P + step - 1
        ancestry[:, pos - base] = own_row
        emb = gpt2_embed_tokens(lm, tokens[:, :, step - 1].reshape(B, 1), dtype)
        step_logits, cache = gpt2_apply(lm, inputs_embeds=emb, kv_cache=cache,
                                        cache_index=pos, dtype=dtype, beam_size=K,
                                        ancestry=ancestry, cache_base=base, shared_kv=shared,
                                        shared_len=c if C > 0 else None)
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
