"""Public generation API, backed by the KV-cached decode loops.

Counterpart of ``clipcap_tpu/inference/generate.py``, with its conventions:
``number_to_generate`` sampling candidates run as one batched decode;
``generate_beam`` returns exactly ``number_to_generate`` captions (cycling
the ranked beams past ``beam_size``); the stop token is '.' for
``generate_no_beam`` / ``generate_nucleus_sampling`` and EOS for
``generate_beam``; nucleus sampling keeps the stop token in its output,
``generate_no_beam`` does not.  ``seed`` seeds a ``torch.Generator`` on the
model's device, so sampled captions differ from the JAX package's except
where the choice is deterministic (e.g. ``top_k=1``).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from clipcap_tpu_torch.inference.beam import BeamParams, beam_search
from clipcap_tpu_torch.inference.engine import DecodeResult, SamplingParams, decode
from clipcap_tpu_torch.models.clipcap import ClipCapModel
from clipcap_tpu_torch.models.gpt2 import gpt2_embed_tokens


def _prep_embeds(model: ClipCapModel, embeds, text_prefix_tokens, dtype) -> torch.Tensor:
    """The mapper prefix, followed by the text-prefix token embeddings."""
    embeds = torch.as_tensor(embeds, device=model.device).to(dtype)
    if embeds.shape[0] != 1:
        raise ValueError("pass a single sample; candidates are batched internally")
    if text_prefix_tokens is not None:
        tp = gpt2_embed_tokens(model.language_model,
                               torch.as_tensor(text_prefix_tokens, device=model.device), dtype)
        embeds = torch.cat([embeds, tp], dim=1)
    return embeds


def _prefix_ids(text_prefix_tokens) -> List[int]:
    if text_prefix_tokens is None:
        return []
    return [int(t) for t in np.asarray(text_prefix_tokens).reshape(-1)]


def _decode_texts(tokenizer, prefix_ids: List[int], result: DecodeResult) -> List[str]:
    toks, lens = result.tokens.cpu().numpy(), result.lengths.cpu().numpy()
    return [tokenizer.decode(prefix_ids + [int(t) for t in row[:int(n)]])
            for row, n in zip(toks, lens)]


def _generator(model: ClipCapModel, seed: int) -> torch.Generator:
    return torch.Generator(device=model.device).manual_seed(seed)


def generate_no_beam(model: ClipCapModel, tokenizer, embeds, number_to_generate: int = 5,
                     text_prefix_tokens=None, top_p: float = 0.9, top_k: int = 0,
                     entry_length: int = 67, temperature: float = 1.0,
                     repetition_penalty: float = 1.2, desired_sentence_length: int = 50,
                     sentence_length_factor: float = 1.0, seed: int = 0,
                     int8_kv: bool = False, dtype=torch.float32) -> List[str]:
    embeds = _prep_embeds(model, embeds, text_prefix_tokens, dtype)
    tiled = embeds.expand(number_to_generate, -1, -1)
    prefix_ids = _prefix_ids(text_prefix_tokens)
    ptoks = None
    if prefix_ids:
        ptoks = torch.tensor(prefix_ids, device=model.device)[None].expand(
            number_to_generate, -1)
    sp = SamplingParams(
        max_new_tokens=entry_length, temperature=temperature, top_k=int(top_k),
        top_p=float(top_p), repetition_penalty=repetition_penalty,
        desired_sentence_length=desired_sentence_length,
        sentence_length_factor=sentence_length_factor,
        stop_token=tokenizer.encode(".")[0], include_stop_token=False, mode="sample",
        int8_kv=int8_kv)
    result = decode(model.language_model, tiled, _generator(model, seed), sp,
                    prefix_tokens=ptoks, dtype=dtype)
    return _decode_texts(tokenizer, prefix_ids, result)


def generate_nucleus_sampling(model: ClipCapModel, tokenizer, embeds,
                              number_to_generate: int = 1, text_prefix_tokens=None,
                              entry_length: int = 67, top_p: float = 0.8, top_k: int = 0,
                              temperature: float = 1.0, seed: int = 0,
                              int8_kv: bool = False, dtype=torch.float32) -> List[str]:
    embeds = _prep_embeds(model, embeds, text_prefix_tokens, dtype)
    tiled = embeds.expand(number_to_generate, -1, -1)
    sp = SamplingParams(
        max_new_tokens=entry_length, temperature=temperature,
        top_k=int(top_k) if top_k else 0, top_p=float(top_p) if top_p else 1.0,
        repetition_penalty=1.0, sentence_length_factor=0.0,
        stop_token=tokenizer.encode(".")[0], include_stop_token=True, mode="nucleus",
        int8_kv=int8_kv)
    result = decode(model.language_model, tiled, _generator(model, seed), sp, dtype=dtype)
    return _decode_texts(tokenizer, _prefix_ids(text_prefix_tokens), result)


def generate_beam(model: ClipCapModel, tokenizer, embeds, number_to_generate: int = 1,
                  text_prefix_tokens=None, beam_size: int = 5, entry_length: int = 67,
                  temperature: float = 1.0, int8_kv: bool = False,
                  dtype=torch.float32) -> List[str]:
    embeds = _prep_embeds(model, embeds, text_prefix_tokens, dtype)
    bp = BeamParams(beam_size=beam_size, max_new_tokens=entry_length,
                    temperature=temperature, stop_token=tokenizer.eos_token_id,
                    int8_kv=int8_kv)
    result = beam_search(model.language_model, embeds, bp, dtype=dtype)
    toks, lens = result.tokens.cpu().numpy(), result.seq_lengths.cpu().numpy()
    order = np.argsort(-result.scores.cpu().numpy())
    texts = [tokenizer.decode([int(t) for t in toks[i][:int(lens[i])]]) for i in order]
    n = max(1, number_to_generate)
    # Exactly number_to_generate captions, as the reference returns: past
    # beam_size the ranked beams repeat.
    return [texts[i % len(texts)] for i in range(n)]


def generate(model: ClipCapModel, tokenizer, embeddings, top_p: float = 0.95,
             top_k: int = 0, temperature: float = 1.0, number_to_generate: int = 5,
             text_prefix: Optional[str] = None, stop_token: Optional[str] = None,
             seed: int = 0, int8_kv: bool = False, dtype=torch.float32) -> List[str]:
    """bos (+ optional text prefix) tokens → mapper prefix → sampling decode.
    ``stop_token`` is accepted for signature parity; the decode stops on '.'."""
    if len(embeddings) != 1:
        raise ValueError("single-sample API: pass one embedding")
    text = tokenizer.bos_token + (text_prefix if text_prefix is not None else "")
    text_prefix_tokens = np.asarray(tokenizer.encode(text), np.int64)[None, :]
    prefix = model.transformer_mapper(embeddings, dtype=dtype)
    return generate_no_beam(model, tokenizer, prefix, number_to_generate=number_to_generate,
                            text_prefix_tokens=text_prefix_tokens, top_p=top_p, top_k=top_k,
                            temperature=temperature, seed=seed, int8_kv=int8_kv, dtype=dtype)
