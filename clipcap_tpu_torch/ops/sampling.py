"""Logit processors and sampling primitives over ``[B, V]`` logit batches.

Counterpart of ``clipcap_tpu/ops/sampling.py``; the same functions with
the same arithmetic.  Randomness comes from an explicit
``torch.Generator`` on the logits' device; its draws differ from JAX's,
so the two packages agree token for token only where the choice is
deterministic (a single surviving candidate).
"""
from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

NEG_INF = -1e9
# Top-p prefilter window: the nucleus is cut from the top 128 logits, as in
# the JAX package (exact whenever the cutoff lands inside the window).
_TOPP_PREFILTER = 128


def _scatter_rows(V: int, idx: Tensor, vals: Tensor, fill: float) -> Tensor:
    out = torch.full((idx.shape[0], V), fill, dtype=vals.dtype, device=vals.device)
    return out.scatter(-1, idx, vals)


def top_k_top_p_filter(logits: Tensor, top_k: int = 0, top_p: float = 0.0) -> Tensor:
    """Tokens outside the top-k, or past the smallest set whose cumulative
    probability exceeds ``top_p``, get NEG_INF.  0 / 0.0 disable a filter."""
    V = logits.shape[-1]
    out = logits
    if top_k and top_k > 0:
        kth = torch.topk(out, min(int(top_k), V), dim=-1).values.amin(-1, keepdim=True)
        out = out.masked_fill(out < kth, NEG_INF)
    if top_p and 0.0 < top_p < 1.0:
        top_vals, top_idx = torch.topk(out, min(V, _TOPP_PREFILTER), dim=-1)
        denom = torch.logsumexp(out.float(), dim=-1, keepdim=True)
        cum = torch.cumsum(torch.exp(top_vals.float() - denom), dim=-1)
        # Shift right so the first token crossing the threshold survives.
        remove = torch.cat([torch.zeros_like(cum[..., :1], dtype=torch.bool),
                            cum[..., :-1] > top_p], dim=-1)
        kept = top_vals.masked_fill(remove, NEG_INF)
        out = _scatter_rows(V, top_idx, kept, NEG_INF)
    return out


def repetition_penalty_apply(logits: Tensor, tokens: Tensor, penalty: float,
                             valid: Optional[Tensor] = None) -> Tensor:
    """Penalise already-generated tokens: ``tokens`` [B, T] buffer, ``valid``
    [B, T] marks its real entries."""
    gathered = logits.gather(-1, tokens.long())
    penalized = torch.where(gathered < 0, gathered * penalty, gathered / penalty)
    if valid is not None:
        penalized = torch.where(valid, penalized, gathered)
    return logits.scatter(-1, tokens.long(), penalized)


def sentence_length_penalty_apply(logits: Tensor, stop_token: int, current_length: int,
                                  desired_length: int, length_factor: float) -> Tensor:
    """Scale the stop token's logit by ``(len/desired)·factor``."""
    out = logits.clone()
    out[..., stop_token] = logits[..., stop_token] * (
        current_length / desired_length * length_factor)
    return out


def _nucleus_window(logits: Tensor, top_k: int, top_p: float):
    """Top-k probabilities (k = ``top_k`` or the prefilter window) censored
    past the ``top_p`` cutoff → ``(censored probs, token ids)``, both [B, k]."""
    V = logits.shape[-1]
    k = min(int(top_k) if top_k else _TOPP_PREFILTER, V)
    probs = torch.softmax(logits.float(), dim=-1)
    p, idx = torch.topk(probs, k, dim=-1)
    cum = torch.cumsum(p, dim=-1)
    total = cum.amax(-1, keepdim=True)
    over = torch.where(cum >= top_p, cum, torch.full_like(cum, float("inf")))
    cutoffs = torch.minimum(over.amin(-1, keepdim=True), total)
    return torch.where(cum <= cutoffs, p, torch.zeros_like(p)), idx


def nucleus_renormalize(logits: Tensor, top_k: int, top_p: float) -> Tensor:
    """The reference's nucleus construction → probabilities [B, V]: top-k
    probabilities within the ``top_p`` cutoff, renormalised."""
    censored, idx = _nucleus_window(logits, top_k, top_p)
    renorm = censored / censored.sum(-1, keepdim=True).clamp_min(1e-20)
    return _scatter_rows(logits.shape[-1], idx, renorm, 0.0)


def sample_categorical(generator: torch.Generator, logits: Tensor) -> Tensor:
    """One draw per row from ``softmax(logits)`` → [B] int64."""
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def nucleus_sample(generator: torch.Generator, logits: Tensor, top_k: int,
                   top_p: float) -> Tensor:
    """Nucleus-renormalise then sample, drawing over the ≤ k candidates."""
    censored, idx = _nucleus_window(logits, top_k, top_p)
    j = sample_categorical(generator, torch.log(censored.clamp_min(1e-20)))
    return idx.gather(-1, j[:, None])[:, 0]


def filtered_sample(generator: torch.Generator, logits: Tensor, live_k: int = 0) -> Tensor:
    """Sample from already-filtered logits, over the top ``live_k`` (or the
    prefilter window) candidates."""
    k = min(live_k if live_k else _TOPP_PREFILTER, logits.shape[-1])
    vals, idx = torch.topk(logits, k, dim=-1)
    j = sample_categorical(generator, vals)
    return idx.gather(-1, j[:, None])[:, 0]
