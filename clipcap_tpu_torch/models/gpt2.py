"""GPT-2 decoder family in PyTorch, with the JAX package's KV cache.

Counterpart of ``clipcap_tpu/models/gpt2.py``.  :class:`GPT2` holds the
weights under HF ``GPT2Model`` keys (``wte``, ``wpe``, ``h.{i}.attn.c_attn``
…), so ``clipcap_tpu.models.hf_import.gpt2_params_from_hf`` reads its state
dict.  The forward is :func:`gpt2_apply`, as in the JAX package:

* full sequence (``kv_cache=None``): causal self-attention over the input;
* cached: one buffer per layer ``[rows, n_head, slots, 2·head_dim]`` with K
  and V interleaved (K in ``[..., :head_dim]``).  Prefill (S > 1) attends
  block-locally and writes the cache; decode (S = 1) attends over the
  written slots through ``ops.flash_decode`` — the CUDA kernel for a cache
  on the card, its plain twin for a cache on the CPU.  The cache is updated
  in place (the JAX package returns a new buffer; here the returned list is
  the one passed in).
* beam decode (``beam_size`` K + ``ancestry``): rows are grouped K per
  sample, beam caches are time-major (slot ``t·K + kb``), and the beam
  reorder is an ancestry mask over the slots — the cache never moves.
  With ``cache_base`` P the first P slots hold the prefix once, visible to
  every beam (the folded-prefix layout, ``init_kv_cache(prefix_slots=P)``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipcap_tpu_torch.ops.flash_decode import flash_decode
from clipcap_tpu_torch.ops.layers import (ACTIVATIONS, Conv1D, LayerNorm, embed,
                                          empty_param, normal_init, ones_init,
                                          round_up, zeros_init)

Tensor = torch.Tensor

NEG_INF = -1e9  # finite mask value: keeps softmax well-defined in bf16


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    activation: str = "gelu_new"
    name: str = "gpt2"
    # Column layout of the packed c_attn weight: "qkv" (HF: q | k | v).  The
    # JAX package's head-major "head" layout serves its tensor-parallel
    # paths, which are not ported (ROADMAP.md, A9).
    qkv_packing: str = "qkv"

    def __post_init__(self):
        if self.qkv_packing != "qkv":
            raise NotImplementedError(
                f"qkv_packing={self.qkv_packing!r}: only the HF 'qkv' layout is ported; "
                "the head-major layout comes with tensor parallelism (ROADMAP.md, A9)")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


GPT2_PRESETS: Dict[str, GPT2Config] = {
    "distilgpt2": GPT2Config(n_layer=6, name="distilgpt2"),
    "gpt2": GPT2Config(name="gpt2"),
    "gpt2-medium": GPT2Config(n_embd=1024, n_layer=24, n_head=16, name="gpt2-medium"),
    "gpt2-large": GPT2Config(n_embd=1280, n_layer=36, n_head=20, name="gpt2-large"),
    "gpt2-xl": GPT2Config(n_embd=1600, n_layer=48, n_head=25, name="gpt2-xl"),
    # Test-scale preset (not an HF model): full GPT-2 vocab, tiny body.
    "gpt2-test": GPT2Config(n_embd=64, n_layer=2, n_head=4, n_positions=256,
                            name="gpt2-test"),
}


def get_gpt2_config(name: str) -> GPT2Config:
    if name in GPT2_PRESETS:
        return GPT2_PRESETS[name]
    raise ValueError(f"unknown GPT-2 preset '{name}'. Known: {sorted(GPT2_PRESETS)}. "
                     "Pass a GPT2Config directly for custom sizes.")


def init_gpt2(cfg: GPT2Config, seed: int = 0) -> dict:
    """Seeded weights as the JAX package's parameter tree (numpy, layer-
    stacked): the same draws as ``clipcap_tpu.models.gpt2.init_gpt2``."""
    rng = np.random.default_rng(seed)
    L, D = cfg.n_layer, cfg.n_embd
    F = 4 * D

    def ln(d):
        return {"scale": ones_init((L, d)), "bias": zeros_init((L, d))}

    return {
        "wte": normal_init(rng, (cfg.vocab_size, D)),
        "wpe": normal_init(rng, (cfg.n_positions, D), std=0.01),
        "h": {
            "ln_1": ln(D),
            "attn": {
                "c_attn": {"w": normal_init(rng, (L, D, 3 * D)), "b": zeros_init((L, 3 * D))},
                "c_proj": {"w": normal_init(rng, (L, D, D)), "b": zeros_init((L, D))},
            },
            "ln_2": ln(D),
            "mlp": {
                "c_fc": {"w": normal_init(rng, (L, D, F)), "b": zeros_init((L, F))},
                "c_proj": {"w": normal_init(rng, (L, F, D)), "b": zeros_init((L, D))},
            },
        },
        "ln_f": {"scale": ones_init((D,)), "bias": zeros_init((D,))},
    }


class _Attention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_attn = Conv1D(d, 3 * d)
        self.c_proj = Conv1D(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.c_fc = Conv1D(d, 4 * d)
        self.c_proj = Conv1D(4 * d, d)


class _Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        d, eps = cfg.n_embd, cfg.layer_norm_epsilon
        self.ln_1 = LayerNorm(d, eps)
        self.attn = _Attention(d)
        self.ln_2 = LayerNorm(d, eps)
        self.mlp = _MLP(d)


class GPT2(nn.Module):
    """GPT-2 weights under HF ``GPT2Model`` keys; the LM head is tied to
    ``wte``.  Built empty: weights come from ``convert.gpt2_from_params``."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.config = cfg
        self.wte = nn.Module()
        self.wte.weight = empty_param(cfg.vocab_size, cfg.n_embd)
        self.wpe = nn.Module()
        self.wpe.weight = empty_param(cfg.n_positions, cfg.n_embd)
        self.h = nn.ModuleList(_Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = LayerNorm(cfg.n_embd, cfg.layer_norm_epsilon)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

# Slot counts are padded to this quantum so the cache holds the same slot
# count as the JAX package's, and the masks of the two line up slot for
# slot.  Slots past the logical capacity are never written and never read.
CACHE_SLOT_QUANTUM = 16


def _beam_cache_slots(n: int, quantum: int) -> int:
    """Slot count of a beam cache: ``n`` rounded up to ``quantum``, or to a
    multiple of 128 when that admits no divisor tile of 64..128 slots (the
    JAX package's rule, kept for identical layouts)."""
    s = round_up(n, quantum)
    best = 0
    for t in range(16, min(128, s) + 1, 16):
        if s % t == 0:
            best = t
    if best < 64:
        s = round_up(n, 128)
    return s


def init_kv_cache(cfg: GPT2Config, batch: int, max_len: int,
                  dtype=torch.bfloat16, beam_size: Optional[int] = None,
                  prefix_slots: int = 0, device="cpu") -> List[Tensor]:
    """Zeroed per-layer interleaved K|V buffers ``[rows, n_head, slots,
    2·head_dim]``.

    Plain: rows = ``batch``, slot t = position t.  With ``beam_size`` K:
    rows = ``batch // K`` sample groups, time-major slot ``t·K + kb``.
    With ``prefix_slots`` P (beam only): slots ``[0, P)`` hold the prefix
    once and position ``t ≥ P`` of beam row kb lives at ``P + (t-P)·K + kb``.
    """
    if prefix_slots:
        if beam_size is None:
            raise ValueError("prefix_slots requires beam mode")
        slots = _beam_cache_slots(prefix_slots + beam_size * max_len, CACHE_SLOT_QUANTUM)
        rows = batch // beam_size
    elif beam_size is not None:
        slots = round_up(beam_size * max_len, CACHE_SLOT_QUANTUM)
        rows = batch // beam_size
    else:
        slots = round_up(max_len, CACHE_SLOT_QUANTUM)
        rows = batch
    shape = (rows, cfg.n_head, slots, 2 * cfg.head_dim)
    return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(cfg.n_layer)]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _split_qkv(qkv: Tensor, cfg: GPT2Config) -> Tuple[Tensor, Tensor, Tensor]:
    return tuple(qkv.split(cfg.n_embd, dim=-1))


def _softmax_attend(q: Tensor, k: Tensor, v: Tensor, bias: Optional[Tensor],
                    scale: float) -> Tensor:
    """softmax(q·kᵀ·scale + bias)·v over the last two dims: fp32 logits and
    softmax, weights cast back to q's dtype (the JAX package's XLA path)."""
    logits = (torch.matmul(q, k.transpose(-1, -2)) * scale).float()
    if bias is not None:
        logits = logits + bias
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(w, v)


def _mlp(x: Tensor, layer: _Block, cfg: GPT2Config) -> Tensor:
    h = layer.mlp.c_fc(layer.ln_2(x))
    return x + layer.mlp.c_proj(ACTIVATIONS[cfg.activation](h))


def _decode_attend(q: Tensor, ckv: Tensor, mask: Tensor, u_valid: int) -> Tensor:
    """Single-token attention over the written cache slots, through the
    kernel wrapper (the kernel on the card, its twin on the CPU)."""
    return flash_decode(q.contiguous(), ckv, mask.contiguous(), u_valid)


def _cached_block(x: Tensor, layer: _Block, ckv: Tensor, cache_index: int,
                  bias: Optional[Tensor], cfg: GPT2Config,
                  beam_size: Optional[int] = None,
                  ancestry: Optional[Tensor] = None,
                  cache_base: int = 0) -> Tensor:
    """One block in cached (prefill/decode) mode; writes ``ckv`` in place.

    Prefill (S > 1) attends within the block only (the zero-filled cache
    is never read), so it assumes ``cache_index == 0``.  Decode (S == 1)
    attends over the written slots ``[0, u_valid)``.  In beam mode
    ``ancestry`` is the per-step ``[R, K, slots]`` selection mask built by
    :func:`gpt2_apply`."""
    B, S, D = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    scale = 1.0 / math.sqrt(Dh)

    q, k, v = _split_qkv(layer.attn.c_attn(layer.ln_1(x)), cfg)

    if beam_size is None:
        q = q.reshape(B, S, H, Dh).transpose(1, 2)          # [B, H, S, Dh]
        k = k.reshape(B, S, H, Dh).transpose(1, 2)
        v = v.reshape(B, S, H, Dh).transpose(1, 2)
        ckv[:, :, cache_index:cache_index + S] = torch.cat([k, v], dim=-1)
        if S > 1:
            attn = _softmax_attend(q, k, v, None if bias is None else bias[..., :S], scale)
        else:                                # bias: the causal (+ pad) mask [Bm, 1, 1, T]
            attn = _decode_attend(q, ckv, bias[:, 0], cache_index + 1)
        attn_out = attn.transpose(1, 2).reshape(B, S, D)
    else:
        K = beam_size
        R = B // K
        qg = q.reshape(R, K, S, H, Dh).permute(0, 3, 1, 2, 4)   # [R, H, K, S, Dh]
        kg = k.reshape(R, K, S, H, Dh).permute(0, 3, 1, 2, 4)
        vg = v.reshape(R, K, S, H, Dh).permute(0, 3, 1, 2, 4)
        # Time-major slots: positions [cache_index, cache_index + S) of all K
        # rows are one contiguous slot range, past the folded prefix.
        new_flat = torch.cat([kg, vg], -1).transpose(2, 3).reshape(R, H, S * K, 2 * Dh)
        live_index = cache_index - cache_base
        slot0 = cache_base + live_index * K
        ckv[:, :, slot0:slot0 + S * K] = new_flat
        if ancestry is None:
            # Prefill of the replicated layout: block-local per (r, h, k).
            attn = _softmax_attend(qg, kg, vg, None if bias is None else bias[0, 0, :, :S],
                                   scale)                        # [R, H, K, S, Dh]
            attn_out = attn.permute(0, 2, 3, 1, 4).reshape(B, S, D)
        else:
            if S != 1:
                raise ValueError("beam decode takes one token per step")
            attn = _decode_attend(qg[:, :, :, 0], ckv, ancestry,
                                  cache_base + (live_index + 1) * K)
            attn_out = attn.transpose(1, 2).reshape(B, S, D)

    x = x + layer.attn.c_proj(attn_out)
    return _mlp(x, layer, cfg)


def _block(x: Tensor, layer: _Block, bias: Optional[Tensor], cfg: GPT2Config) -> Tensor:
    """One block over the full sequence (no cache)."""
    B, S, D = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    q, k, v = (t.reshape(B, S, H, Dh).transpose(1, 2)
               for t in _split_qkv(layer.attn.c_attn(layer.ln_1(x)), cfg))
    attn = _softmax_attend(q, k, v, bias, 1.0 / math.sqrt(Dh))
    x = x + layer.attn.c_proj(attn.transpose(1, 2).reshape(B, S, D))
    return _mlp(x, layer, cfg)


def causal_bias(S: int, T: int, offset: int = 0, device="cpu") -> Tensor:
    """Additive causal bias [1, 1, S, T]: query i may attend key j iff
    j <= offset + i."""
    q_pos = torch.arange(S, device=device)[:, None] + offset
    k_pos = torch.arange(T, device=device)[None, :]
    bias = torch.where(k_pos <= q_pos, 0.0, NEG_INF).to(torch.float32)
    return bias[None, None]


def beam_mask(ancestry: Tensor, beam_size: int, slots: int, offset: int,
              cache_base: int = 0) -> Tensor:
    """The per-step beam selection mask ``[R, K, slots]`` fp32: 0 where
    time-major slot ``cache_base + (t - cache_base)·K + j`` holds beam k's
    K/V for a position t ≤ ``offset`` (``ancestry[b, t - cache_base] == j``)
    or lies in the folded prefix ``[0, cache_base)``; NEG_INF elsewhere."""
    K = beam_size
    B, Tl = ancestry.shape
    R = B // K
    fold = cache_base
    anc = ancestry.reshape(R, K, Tl).repeat_interleave(K, dim=-1)
    anc = torch.nn.functional.pad(anc, (fold, slots - fold - K * Tl), value=-1)
    s_iota = torch.arange(slots, device=ancestry.device)
    s_rel = (s_iota - fold).clamp_min(0)                    # live-region slot
    pos = cache_base + s_rel // K                           # absolute position
    visible = (anc == s_rel % K) & (pos <= offset)
    if fold:
        visible = visible | (s_iota < fold)
    return torch.where(visible, 0.0, NEG_INF).to(torch.float32)


def gpt2_apply(model: GPT2, *, input_ids: Optional[Tensor] = None,
               inputs_embeds: Optional[Tensor] = None,
               attention_mask: Optional[Tensor] = None,
               kv_cache: Optional[List[Tensor]] = None, cache_index: int = 0,
               dtype=torch.float32, return_logits: bool = True,
               beam_size: Optional[int] = None, ancestry: Optional[Tensor] = None,
               cache_base: int = 0, remat: bool = False):
    """GPT-2 forward → ``(logits_or_hidden, kv_cache)``.

    ``kv_cache=None``: full-sequence causal attention (``attention_mask``
    [B, S] marks valid tokens); with ``remat`` each block runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass, as
    the JAX package's ``jax.checkpoint`` over the block.  Cached: writes
    the new K/V at the host int ``cache_index``; ``attention_mask`` is then
    over cache slots.  Beam decode: ``beam_size`` K and ``ancestry``
    [B, Tl] (``ancestry[b, t]`` = the group row holding beam b's K/V for
    position ``cache_base + t``).
    """
    cfg = model.config
    if inputs_embeds is None:
        inputs_embeds = embed(model.wte.weight, input_ids, dtype)
    x = inputs_embeds.to(dtype)
    B, S, D = x.shape
    dev = x.device

    if kv_cache is not None:
        slots = kv_cache[0].shape[2]
        if S > 1 and cache_index != 0:
            raise ValueError("cached prefill (S > 1) requires cache_index == 0: "
                             "prefill attention is block-local and ignores earlier "
                             f"cache contents (got cache_index={cache_index})")
        offset = cache_index
        T = S if beam_size is not None else slots
    else:
        offset = 0
        T = S

    x = x + model.wpe.weight[offset:offset + S].to(dtype)[None]

    bias = causal_bias(S, T, offset, device=dev)
    if attention_mask is not None:
        if attention_mask.shape[-1] < T:
            attention_mask = torch.nn.functional.pad(
                attention_mask, (0, T - attention_mask.shape[-1]))
        pad_bias = torch.where(attention_mask.bool(), 0.0, NEG_INF).to(torch.float32)
        bias = bias + pad_bias[:, None, None, :]

    if kv_cache is not None:
        mask = None
        if ancestry is not None:
            if beam_size is None or S != 1:
                raise ValueError("ancestry needs beam_size and one token per step")
            mask = beam_mask(ancestry, beam_size, slots, offset, cache_base)
        for layer, ckv in zip(model.h, kv_cache):
            x = _cached_block(x, layer, ckv, cache_index, None if mask is not None else bias,
                              cfg, beam_size=beam_size, ancestry=mask,
                              cache_base=cache_base)
    else:
        for layer in model.h:
            if remat:
                x = checkpoint(_block, x, layer, bias, cfg, use_reentrant=False)
            else:
                x = _block(x, layer, bias, cfg)

    x = model.ln_f(x)
    return (lm_logits(model, x) if return_logits else x), kv_cache


def gpt2_embed_tokens(model: GPT2, token_ids: Tensor, dtype=torch.float32) -> Tensor:
    """Token-embedding lookup (``get_input_embeddings()(tokens)``)."""
    return embed(model.wte.weight, token_ids, dtype)


def lm_logits(model: GPT2, hidden: Tensor) -> Tensor:
    """Project hidden states onto the vocabulary (the tied LM head)."""
    return hidden @ model.wte.weight.to(hidden.dtype).t()
