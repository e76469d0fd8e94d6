"""KV-cached sampling decode.

Counterpart of ``clipcap_tpu/inference/engine.py``: the prefix is prefilled
into a preallocated cache in one pass, then a Python loop of single-token
steps (logit processing → token choice → one cached forward) runs until
``max_new_tokens`` or until every row has emitted the stop token.  The
loop knows the step on the host, so each step's decode attention reads
exactly the slots written so far.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from clipcap_tpu_torch.models.gpt2 import (GPT2, gpt2_apply, gpt2_embed_tokens,
                                           init_kv_cache, lm_logits)
from clipcap_tpu_torch.ops import sampling

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    max_new_tokens: int = 67
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 0.0
    repetition_penalty: float = 1.0
    desired_sentence_length: int = 50
    sentence_length_factor: float = 0.0  # > 0 enables the stop-logit scaling
    stop_token: int = 50256
    include_stop_token: bool = False     # nucleus keeps the stop token; no_beam doesn't
    mode: str = "sample"                 # "greedy" | "sample" | "nucleus"
    pad_token: int = 0
    int8_kv: bool = False                # int8 KV cache with per-slot absmax scales
    tile_major: Optional[bool] = None    # tile-major cache; None: env CLIPCAP_CACHE_TILE_MAJOR


class DecodeResult(NamedTuple):
    tokens: Tensor   # [B, max_new_tokens] int64, pad-filled after stop
    lengths: Tensor  # [B] int64, number of real tokens


def _process_logits(logits: Tensor, tokens: Tensor, valid: Tensor, step: int,
                    sp: SamplingParams) -> Tensor:
    logits = logits.float()
    if sp.repetition_penalty != 1.0:
        logits = sampling.repetition_penalty_apply(logits, tokens, sp.repetition_penalty, valid)
    logits = logits / (sp.temperature if sp.temperature > 0 else 1.0)
    if sp.mode != "nucleus":
        logits = sampling.top_k_top_p_filter(logits, sp.top_k, sp.top_p)
    if sp.sentence_length_factor > 0.0:
        logits = sampling.sentence_length_penalty_apply(
            logits, sp.stop_token, step, sp.desired_sentence_length, sp.sentence_length_factor)
    return logits


def _select_token(logits: Tensor, generator: torch.Generator, sp: SamplingParams) -> Tensor:
    if sp.mode == "greedy":
        return logits.argmax(dim=-1)
    if sp.mode == "nucleus":
        if sp.top_p >= 1.0 and not sp.top_k:
            return sampling.sample_categorical(generator, logits)
        return sampling.nucleus_sample(generator, logits, sp.top_k, sp.top_p)
    if sp.top_k or 0.0 < sp.top_p < 1.0:
        return sampling.filtered_sample(generator, logits, live_k=int(sp.top_k))
    return sampling.sample_categorical(generator, logits)


@torch.no_grad()
def decode(lm: GPT2, prefix_embeds: Tensor, generator: torch.Generator,
           sp: SamplingParams, prefix_tokens: Optional[Tensor] = None,
           dtype=torch.bfloat16) -> DecodeResult:
    """Generate up to ``sp.max_new_tokens`` per row.

    ``prefix_embeds`` [B, P, D] (mapper prefix, plus any text-prefix
    embeddings); ``prefix_tokens`` [B, Tp] seeds the repetition-penalty
    buffer.  ``generator`` lives on the model's device."""
    B, P, D = prefix_embeds.shape
    N = sp.max_new_tokens
    dev = prefix_embeds.device
    cache = init_kv_cache(lm.config, B, P + N, dtype=dtype, int8=sp.int8_kv, device=dev,
                          tile_major=sp.tile_major)
    hidden, cache = gpt2_apply(lm, inputs_embeds=prefix_embeds.to(dtype), kv_cache=cache,
                               cache_index=0, dtype=dtype, return_logits=False)
    cur_logits = lm_logits(lm, hidden[:, -1])                       # [B, V]

    Tp = 0 if prefix_tokens is None else prefix_tokens.shape[1]
    buf = torch.zeros((B, Tp + N), dtype=torch.long, device=dev)
    valid = torch.zeros((B, Tp + N), dtype=torch.bool, device=dev)
    if prefix_tokens is not None:
        buf[:, :Tp] = prefix_tokens
        valid[:, :Tp] = True
    out_tokens = torch.full((B, N), sp.pad_token, dtype=torch.long, device=dev)
    stopped = torch.zeros(B, dtype=torch.bool, device=dev)
    lengths = torch.zeros(B, dtype=torch.long, device=dev)

    for step in range(N):
        if bool(stopped.all()):
            break
        # current length for the sentence-length penalty includes the text prefix
        proc = _process_logits(cur_logits, buf, valid, Tp + step, sp)
        next_tok = _select_token(proc, generator, sp)
        is_stop = next_tok == sp.stop_token
        record = ~stopped if sp.include_stop_token else ~stopped & ~is_stop
        out_tokens[:, step] = torch.where(record, next_tok, out_tokens[:, step])
        lengths += record.long()
        buf[:, Tp + step] = torch.where(record, next_tok, buf[:, Tp + step])
        valid[:, Tp + step] |= record
        stopped |= is_stop

        feed = torch.where(stopped, sp.pad_token, next_tok)
        emb = gpt2_embed_tokens(lm, feed[:, None], dtype)
        step_logits, cache = gpt2_apply(lm, inputs_embeds=emb, kv_cache=cache,
                                        cache_index=P + step, dtype=dtype)
        cur_logits = step_logits[:, 0]
    return DecodeResult(tokens=out_tokens, lengths=lengths)
