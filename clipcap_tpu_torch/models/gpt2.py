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
* beam decode (``beam_size`` K + ``ancestry``): the beam layout of
  ``models/decoding.py``, with the folded prefix from
  ``init_kv_cache(prefix_slots=P)``.  A step runs as L + 1 dense segments
  split at the layers' decode attentions (CUDA graphs on the card).
* tile-major caches (``init_kv_cache(tile_major=True)``, or env
  ``CLIPCAP_CACHE_TILE_MAJOR=1``): the same bf16/fp32 cache stored as
  ``[rows, slots // u, n_head, u, 2·head_dim]`` with the JAX package's
  u-tile ``u``; writes go tile by tile, decode attention reads the layout
  in place.
* int8 caches (``init_kv_cache(int8=True)``): per layer a tuple of int8
  rows and per-(slot, head) fp32 absmax scales for the K and V halves
  (``_quantize_kv``); decode attention reads them through the kernel's
  int8 form.
* converged-prefix consolidation (``shared_kv`` + ``shared_len`` c, from
  ``init_shared_kv`` / ``consolidate_kv_cache``): positions below each
  sample's c are served from a shared cache with one slot per position,
  the live beam cache holds the generated positions only, and decode
  attention is one two-phase kernel pass over both
  (``ops.flash_decode.flash_decode_two_phase``).
* int8 weights (``ops.quant.quantize_gpt2_int8``): the block projections'
  ``Conv1D`` modules hold an ``Int8Weight``, which ``ops.layers.linear``
  serves as a weight-only int8 product in prefill, decode and the
  full-sequence forward alike; decode attention is unchanged.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from clipcap_tpu_torch.models.decoding import (CACHE_SLOT_QUANTUM, NEG_INF, DecodeGraphs,
                                              StepGraphs, beam_slot, beam_step, causal_bias,
                                              softmax_attend)
from clipcap_tpu_torch.models.decoding import beam_mask  # noqa: F401 (portbench reads it here)
from clipcap_tpu_torch.ops.flash_decode import (INT8_SLOT_QUANTUM, _pick_u_tile, flash_decode,
                                                flash_decode_two_phase)
from clipcap_tpu_torch.ops.layers import (ACTIVATIONS, Conv1D, LayerNorm, embed,
                                          empty_param, normal_init, ones_init,
                                          round_up, zeros_init)
from clipcap_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor
# One layer's cache: the interleaved K|V buffer, or (int8 rows, k-scales,
# v-scales) for an int8 cache.
LayerCache = Union[Tensor, Tuple[Tensor, Tensor, Tensor]]

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
        self.decode_graphs = DecodeGraphs()     # beam decode's CUDA graphs, by key

    @property
    def decode_segments(self) -> int:
        """Dense segments of a beam decode step (:func:`_beam_decode_blocks`)."""
        return self.config.n_layer + 1

    def decode_tensors(self):
        """The tensors the segments read: the blocks' and ``ln_f``'s."""
        return (*self.h.parameters(), *self.h.buffers(), *self.ln_f.parameters())


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

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


def _zeros_cache(shape, n_layer: int, dtype, int8: bool, device) -> List[LayerCache]:
    if int8:
        return [(torch.zeros(shape, dtype=torch.int8, device=device),
                 torch.zeros(shape[:3], device=device),
                 torch.zeros(shape[:3], device=device)) for _ in range(n_layer)]
    return [torch.zeros(shape, dtype=dtype, device=device) for _ in range(n_layer)]


def cache_tile_major(tile_major: Optional[bool]) -> bool:
    """Whether a beam cache is tile-major: ``tile_major``, or when None the
    env ``CLIPCAP_CACHE_TILE_MAJOR=1``."""
    if tile_major is None:
        return os.environ.get("CLIPCAP_CACHE_TILE_MAJOR", "0") == "1"
    return tile_major


def init_kv_cache(cfg: GPT2Config, batch: int, max_len: int,
                  dtype=torch.bfloat16, beam_size: Optional[int] = None,
                  prefix_slots: int = 0, int8: bool = False,
                  device="cpu", tile_major: Optional[bool] = None) -> List[LayerCache]:
    """Zeroed per-layer interleaved K|V buffers ``[rows, n_head, slots,
    2·head_dim]``.

    Plain: rows = ``batch``, slot t = position t.  With ``beam_size`` K:
    rows = ``batch // K`` sample groups in the beam layout of
    ``models/decoding.py``, the folded prefix in slots ``[0, prefix_slots)``.
    ``int8``: each layer is ``(int8 rows, sk, sv)`` with fp32 scales
    ``[rows, n_head, slots]``, and slots are padded to 128 (the JAX
    package's int8 quantum, so the masks of the two line up).
    ``tile_major`` (None: env ``CLIPCAP_CACHE_TILE_MAJOR=1``) stores a
    bf16/fp32 cache as ``[rows, slots // u, n_head, u, 2·head_dim]`` with
    ``u = _pick_u_tile(slots)``, the JAX package's shape tile for tile; an
    int8 cache stays strided, as there.
    """
    tile_major = cache_tile_major(tile_major)
    quantum = INT8_SLOT_QUANTUM if int8 else CACHE_SLOT_QUANTUM
    if prefix_slots:
        if beam_size is None:
            raise ValueError("prefix_slots requires beam mode")
        slots = _beam_cache_slots(prefix_slots + beam_size * max_len, quantum)
        rows = batch // beam_size
    elif beam_size is not None:
        slots = round_up(beam_size * max_len, quantum)
        rows = batch // beam_size
    else:
        slots = round_up(max_len, quantum)
        rows = batch
    shape = (rows, cfg.n_head, slots, 2 * cfg.head_dim)
    if tile_major and not int8:
        u = _pick_u_tile(slots)
        shape = (rows, slots // u, cfg.n_head, u, 2 * cfg.head_dim)
    return _zeros_cache(shape, cfg.n_layer, dtype, int8, device)


def init_shared_kv(cfg: GPT2Config, groups: int, max_len: int, dtype=torch.bfloat16,
                   int8: bool = False, device="cpu") -> List[LayerCache]:
    """The consolidated shared-prefix cache of beam decode: one slot per
    position (slot t = position t) for each of ``groups`` samples, laid out
    as :func:`init_kv_cache`'s plain cache.  Beam search prefills the
    prefix straight into it; :func:`consolidate_kv_cache` adds the
    generated positions on which every beam of a sample agrees."""
    quantum = INT8_SLOT_QUANTUM if int8 else CACHE_SLOT_QUANTUM
    shape = (groups, cfg.n_head, round_up(max_len, quantum), 2 * cfg.head_dim)
    return _zeros_cache(shape, cfg.n_layer, dtype, int8, device)


def gpt2_beam_cache(cfg: GPT2Config, bp, groups: int, prefix_len: int, tile_major: bool,
                    dtype, device) -> Tuple[List[LayerCache], Optional[List[LayerCache]]]:
    """``(beam cache, shared cache or None)`` of a beam search over ``groups``
    prefixes of ``prefix_len`` positions in the form ``bp`` (``BeamParams``)
    asks: folded, replicated, or consolidated (the prefix in the shared one)."""
    K, N, int8 = bp.beam_size, bp.max_new_tokens, bp.int8_kv
    kw = dict(dtype=dtype, beam_size=K, int8=int8, device=device)
    if bp.consolidate_every > 0:
        shared = init_shared_kv(cfg, groups, prefix_len + N, dtype, int8, device)
        return init_kv_cache(cfg, groups * K, N, tile_major=False, **kw), shared
    P = prefix_len if bp.fold_prefix else 0      # folded: the prefix once, in slots [0, P)
    return init_kv_cache(cfg, groups * K, N + prefix_len - P, prefix_slots=P,
                         tile_major=tile_major, **kw), None


def _split_cache(ckv: LayerCache) -> Tuple[Tensor, Optional[Tuple[Tensor, Tensor]]]:
    """A layer's cache → (rows, (sk, sv) or None)."""
    if isinstance(ckv, tuple):
        return ckv[0], (ckv[1], ckv[2])
    return ckv, None


def _cache_slots(ckv: LayerCache) -> int:
    """Logical slot count of a layer's cache, strided or tile-major."""
    rows = _split_cache(ckv)[0]
    return rows.shape[1] * rows.shape[3] if rows.dim() == 5 else rows.shape[2]


def consolidate_kv_cache(kv_cache: List[LayerCache], shared_kv: List[LayerCache],
                         rows: Tensor, beam_size: int, base: int = 0) -> List[LayerCache]:
    """Copy the converged beam prefix into the shared cache, in place.

    ``rows`` [groups, W]: for position ``base + w`` of each sample, the beam
    row whose live slot ``w·K + rows[r, w]`` holds its K/V.  Shared slots
    ``[base, base + W)`` are rewritten (slots past the live buffer read its
    last slot; the shared mask hides every position past the converged
    length), slots ``[0, base)`` — the prefilled prefix — are kept.  A plain
    index gather: exact for every cache type, the int8 scales included.
    """
    K = beam_size
    R, W = rows.shape
    idx = beam_slot(torch.arange(W, device=rows.device), K, shared=True) + rows.clamp(0, K - 1)
    for live, shared in zip(kv_cache, shared_kv):
        live_rows, live_scales = _split_cache(live)
        if live_rows.dim() == 5:
            raise ValueError("a tile-major cache does not take consolidation")
        shared_rows, shared_scales = _split_cache(shared)
        n = min(W, shared_rows.shape[2] - base)
        ix = idx[:, :n].clamp_max(live_rows.shape[2] - 1)[:, None, :]          # [R, 1, n]
        H, D2 = live_rows.shape[1], live_rows.shape[3]
        shared_rows[:, :, base:base + n] = torch.gather(
            live_rows, 2, ix[..., None].expand(R, H, n, D2))
        if live_scales is not None:
            for src, dst in zip(live_scales, shared_scales):
                dst[:, :, base:base + n] = torch.gather(src, 2, ix.expand(R, H, n))
    return shared_kv


def _quantize_kv(new_kv: Tensor, Dh: int) -> Tuple[Tensor, Tensor, Tensor]:
    """[..., slots, 2·Dh] bf16/fp32 → (int8 rows, k-scales, v-scales): per
    (slot, head) symmetric absmax scales for each half, round half to even,
    clipped to ±127 (the JAX package's ``_quantize_kv``).  Both halves go
    through each op together: the same arithmetic in half the eager ops."""
    x = new_kv.float().unflatten(-1, (2, Dh))                   # [..., 2, Dh]: K, V
    s = x.abs().amax(dim=-1).clamp_min(1e-8) / 127.0            # [..., 2]
    q = torch.round(x / s[..., None]).clamp(-127, 127).to(torch.int8).flatten(-2)
    return q, s[..., 0], s[..., 1]


def _write_kv(ckv: LayerCache, new_kv: Tensor, slot0: int) -> None:
    """Write K|V rows ``new_kv`` [R, H, S, 2·Dh] at slots ``[slot0,
    slot0 + S)`` of a layer's cache, quantising them for an int8 cache.  In
    a tile-major cache the run is written in place one u-tile at a time (it
    may straddle tiles: slot s lives at tile s // u, offset s % u)."""
    S = new_kv.shape[2]
    if isinstance(ckv, tuple):
        for dst, src in zip(ckv, _quantize_kv(new_kv, new_kv.shape[-1] // 2)):
            dst[:, :, slot0:slot0 + S] = src
    elif ckv.dim() == 5:
        u = ckv.shape[3]
        s = slot0
        while s < slot0 + S:
            n = min(u - s % u, slot0 + S - s)
            ckv[:, s // u, :, s % u:s % u + n] = new_kv[:, :, s - slot0:s - slot0 + n]
            s += n
    else:
        ckv[:, :, slot0:slot0 + S] = new_kv


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _split_qkv(qkv: Tensor, cfg: GPT2Config) -> Tuple[Tensor, Tensor, Tensor]:
    return tuple(qkv.split(cfg.n_embd, dim=-1))


def _mlp(x: Tensor, layer: _Block, cfg: GPT2Config) -> Tensor:
    h = layer.mlp.c_fc(layer.ln_2(x))
    return x + layer.mlp.c_proj(ACTIVATIONS[cfg.activation](h))


def _block_out(x: Tensor, attn_out: Tensor, layer: _Block, cfg: GPT2Config) -> Tensor:
    """The rest of a block after its attention: ``c_proj``, the residual
    add, then the MLP and its residual add."""
    return _mlp(x + layer.attn.c_proj(attn_out), layer, cfg)


def _beam_qkv(x: Tensor, layer: _Block, cfg: GPT2Config, K: int):
    """``ln_1``, ``c_attn`` and the beam split of a block's input [B, S, D]
    → ``(qg, kg, vg)`` [R, H, K, S, Dh] and the K|V rows [R, H, S·K, 2·Dh]
    in time-major slot order (positions of all K rows of a sample are one
    contiguous slot range)."""
    B, S, _ = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    R = B // K
    qg, kg, vg = (t.reshape(R, K, S, H, Dh).permute(0, 3, 1, 2, 4)
                  for t in _split_qkv(layer.attn.c_attn(layer.ln_1(x)), cfg))
    new_flat = torch.cat([kg, vg], -1).transpose(2, 3).reshape(R, H, S * K, 2 * Dh)
    return qg, kg, vg, new_flat


def _decode_attend(q: Tensor, ckv: LayerCache, mask: Tensor, u_valid: int) -> Tensor:
    """Single-token attention over the written cache slots, through the
    kernel wrapper (the kernel on the card, its twin on the CPU)."""
    kv, scales = _split_cache(ckv)
    return flash_decode(q.contiguous(), kv, mask.contiguous(), u_valid, scales=scales)


class _SharedStep(NamedTuple):
    """What every layer of one consolidated decode step shares: the shared
    region's mask ``[Rm, K, Us]`` and the bounds of the two regions (host
    ints, or device int32 ``[R]`` vectors for per-sample lengths)."""
    mask: Tensor
    sh_valid: Union[int, Tensor]      # shared slots [0, c)
    lv_lo: Union[int, Tensor]         # first live slot past the consolidated positions


def _cached_block(x: Tensor, layer: _Block, ckv: LayerCache, cache_index: int,
                  bias: Optional[Tensor], cfg: GPT2Config,
                  beam_size: Optional[int] = None, cache_base: int = 0) -> Tensor:
    """One block in cached mode outside beam decode; writes ``ckv`` in place.

    Prefill (S > 1) attends within the block only (the zero-filled cache
    is never read), so it assumes ``cache_index == 0``.  Plain decode
    (S == 1) attends over the written slots ``[0, cache_index]``.  With
    ``beam_size`` it is the prefill of the replicated beam layout,
    block-local per (row, head, beam); beam decode steps run
    :func:`_beam_decode_blocks`."""
    B, S, D = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    scale = 1.0 / math.sqrt(Dh)

    if beam_size is None:
        q, k, v = (t.reshape(B, S, H, Dh).transpose(1, 2)          # [B, H, S, Dh]
                   for t in _split_qkv(layer.attn.c_attn(layer.ln_1(x)), cfg))
        _write_kv(ckv, torch.cat([k, v], dim=-1), cache_index)
        if S > 1:
            attn = softmax_attend(q, k, v, None if bias is None else bias[..., :S], scale)
        else:                                # bias: the causal (+ pad) mask [Bm, 1, 1, T]
            attn = _decode_attend(q, ckv, bias[:, 0], cache_index + 1)
        attn_out = attn.transpose(1, 2).reshape(B, S, D)
    else:
        qg, kg, vg, new_flat = _beam_qkv(x, layer, cfg, beam_size)
        _write_kv(ckv, new_flat, beam_slot(cache_index, beam_size, cache_base))
        attn = softmax_attend(qg, kg, vg, None if bias is None else bias[0, 0, :, :S],
                               scale)                        # [R, H, K, S, Dh]
        attn_out = attn.permute(0, 2, 3, 1, 4).reshape(B, S, D)
    return _block_out(x, attn_out, layer, cfg)


# ---------------------------------------------------------------------------
# Beam decode steps: dense segments between the decode attentions
# ---------------------------------------------------------------------------
#
# A beam decode step (S = 1 with ancestry) of an L-layer model splits at
# each layer's decode attention into L + 1 dense segments:
#
#   segment 0      ln_1, c_attn and the split of block 0;
#   segment i      the rest of block i - 1 from its attention output (c_proj,
#                  residual, ln_2, c_fc, gelu, c_proj, residual), then the
#                  start of block i as segment 0;
#   segment L      the rest of the last block, then ln_f.
#
# Between two segments the cache write and the decode attention run eagerly
# on the step's host ints (slot, bounds), so every cache form (strided,
# tile-major, int8, consolidated) shares the segments (``models/decoding.py``
# runs them, as CUDA graphs on the card).


def _decode_segment(model: "GPT2", i: int, carry: Optional[tuple], inp: Tensor, K: int):
    """Segment ``i`` of a beam decode step → ``(x, q1, kv_rows)``: the
    residual stream [B, 1, D] entering block i, its queries [R, H, K, Dh]
    and its K|V rows [R, H, K, 2·Dh]; for i = L, ``(hidden, None, None)``
    after ``ln_f``.  ``inp`` is the step's input [B, 1, D] for i = 0, else
    block i - 1's attention output [R, H, K, Dh] after segment i - 1's
    outputs ``carry``."""
    cfg = model.config
    x = inp if i == 0 else _block_out(carry[0], inp.transpose(1, 2).reshape(carry[0].shape),
                                      model.h[i - 1], cfg)
    if i == cfg.n_layer:
        return model.ln_f(x), None, None
    qg, _, _, kv_rows = _beam_qkv(x, model.h[i], cfg, K)
    return x, qg[:, :, :, 0].contiguous(), kv_rows


def _beam_decode_blocks(model: "GPT2", x: Tensor, kv_cache: List[LayerCache], mask: Tensor,
                        slot: int, K: int, shared_kv: Optional[List[LayerCache]],
                        step: Optional[_SharedStep], steps) -> Tensor:
    """The blocks and ``ln_f`` of one beam decode step → the final hidden
    state [B, 1, D]: the segments run through ``steps``, each layer's cache
    write (at ``slot``) and decode attention eagerly between them.  With
    ``shared_kv``, ``step`` holds the shared region's mask and bounds."""

    def segment(i, carry, inp):
        return _decode_segment(model, i, carry, inp, K)

    x, q1, kv_rows = steps.run(segment, 0, x)
    for i, ckv in enumerate(kv_cache):
        _write_kv(ckv, kv_rows, slot)
        if shared_kv is None:
            attn = _decode_attend(q1, ckv, mask, slot + K)
        else:
            lkv, l_scales = _split_cache(ckv)
            if lkv.dim() == 5:
                raise ValueError("a tile-major cache does not take the consolidated "
                                 "shared-prefix form (beam search pins it strided)")
            skv, s_scales = _split_cache(shared_kv[i])
            attn = flash_decode_two_phase(
                q1, skv, step.mask, lkv, mask, sh_valid=step.sh_valid, lv_lo=step.lv_lo,
                lv_valid=slot + K, shared_scales=s_scales, live_scales=l_scales)
        x, q1, kv_rows = steps.run(segment, i + 1, attn)
    return x


def _block(x: Tensor, layer: _Block, bias: Optional[Tensor], cfg: GPT2Config) -> Tensor:
    """One block over the full sequence (no cache)."""
    B, S, D = x.shape
    H, Dh = cfg.n_head, cfg.head_dim
    q, k, v = (t.reshape(B, S, H, Dh).transpose(1, 2)
               for t in _split_qkv(layer.attn.c_attn(layer.ln_1(x)), cfg))
    attn = softmax_attend(q, k, v, bias, 1.0 / math.sqrt(Dh))
    return _block_out(x, attn.transpose(1, 2).reshape(B, S, D), layer, cfg)


def shared_mask(shared_len: Union[int, Tensor], beam_size: int, slots: int,
                device="cpu") -> Tensor:
    """The shared region's mask ``[R or 1, K, slots]`` fp32: 0 on the
    consolidated positions ``[0, c)`` of each sample, NEG_INF past them."""
    c = torch.as_tensor(shared_len, device=device).reshape(-1, 1, 1)
    visible = torch.arange(slots, device=device) < c
    mask = torch.where(visible, 0.0, NEG_INF).to(torch.float32)
    return mask.expand(c.shape[0], beam_size, slots).contiguous()


def _shared_step(shared_kv: List[LayerCache], shared_len: Union[int, Tensor],
                 beam_size: int, cache_base: int, device) -> _SharedStep:
    slots = _split_cache(shared_kv[0])[0].shape[2]
    mask = shared_mask(shared_len, beam_size, slots, device)
    c = (shared_len.to(device=device, dtype=torch.int32).contiguous()
         if isinstance(shared_len, Tensor) else int(shared_len))
    return _SharedStep(mask, c, beam_slot(c, beam_size, cache_base, True))   # int32 for a tensor


def gpt2_apply(model: GPT2, *, input_ids: Optional[Tensor] = None,
               inputs_embeds: Optional[Tensor] = None,
               attention_mask: Optional[Tensor] = None,
               kv_cache: Optional[List[LayerCache]] = None, cache_index: int = 0,
               dtype=torch.float32, return_logits: bool = True,
               beam_size: Optional[int] = None, ancestry: Optional[Tensor] = None,
               cache_base: int = 0, shared_kv: Optional[List[LayerCache]] = None,
               shared_len: Union[int, Tensor, None] = None, remat: bool = False,
               graphs: Optional[StepGraphs] = None):
    """GPT-2 forward → ``(logits_or_hidden, kv_cache)``.

    ``kv_cache=None``: full-sequence causal attention (``attention_mask``
    [B, S] marks valid tokens); with ``remat`` each block runs under
    ``torch.utils.checkpoint`` and is recomputed in the backward pass, as
    the JAX package's ``jax.checkpoint`` over the block.  Cached: writes
    the new K/V at the host int ``cache_index``; ``attention_mask`` is then
    over cache slots.  Beam decode: ``beam_size`` K and ``ancestry``
    [B, Tl] (``ancestry[b, t]`` = the group row holding beam b's K/V for
    position ``cache_base + t``).  Consolidated beam decode adds
    ``shared_kv`` (per-layer caches from :func:`init_shared_kv`) and
    ``shared_len`` c (an int, or a per-sample int ``[R]`` tensor on the
    cache's device): positions below c are read from the shared cache, the
    live cache holds positions from ``cache_base`` on from slot 0.  A beam
    decode step's segments (:func:`_beam_decode_blocks`) replay ``graphs``
    (``decoding.decode_step_graphs``) where given; the hidden state of a
    graphed step is the graphs' static output, valid until their next step.
    """
    cfg = model.config
    if inputs_embeds is None:
        inputs_embeds = embed(model.wte.weight, input_ids, dtype)
    x = inputs_embeds.to(dtype)
    B, S, D = x.shape
    dev = x.device

    if kv_cache is not None:
        slots = _cache_slots(kv_cache[0])
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

    if kv_cache is not None and ancestry is not None:
        with beam_step("gpt2.blocks", x, ancestry, beam_size, slots, offset, cache_base, graphs,
                       shared_len if shared_kv is not None else None) as (mask, slot, steps):
            step = None if shared_kv is None else _shared_step(shared_kv, shared_len, beam_size,
                                                                cache_base, dev)
            x = _beam_decode_blocks(model, x, kv_cache, mask, slot, beam_size, shared_kv, step,
                                    steps)
        return (lm_logits(model, x) if return_logits else x), kv_cache
    if graphs is not None:
        raise ValueError("graphs serve beam decode steps only (ancestry and one token)")

    bias = causal_bias(S, T, offset, device=dev)
    if attention_mask is not None:
        if attention_mask.shape[-1] < T:
            attention_mask = torch.nn.functional.pad(
                attention_mask, (0, T - attention_mask.shape[-1]))
        pad_bias = torch.where(attention_mask.bool(), 0.0, NEG_INF).to(torch.float32)
        bias = bias + pad_bias[:, None, None, :]

    with annotate("gpt2.blocks"):
        if kv_cache is not None:
            for layer, ckv in zip(model.h, kv_cache):
                x = _cached_block(x, layer, ckv, cache_index, bias, cfg, beam_size=beam_size,
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


# The head's row count is padded to a multiple of this.  The logits' leading
# dimension is the row count, and with an odd one (GPT-2's 50,257) cuBLAS can
# only take its align1 kernels, for the product and for its backward.
HEAD_ROW_QUANTUM = 64


def lm_logits(model: GPT2, hidden: Tensor) -> Tensor:
    """Project hidden states onto the vocabulary (the tied LM head).

    The product runs on the head in the hidden states' dtype with zero rows
    appended up to Vp, a multiple of :data:`HEAD_ROW_QUANTUM` (50,304 for
    GPT-2's 50,257), and the logits are the view ``[..., :V]`` of the
    ``[..., Vp]`` product: the pad columns are never ranked, sampled or put
    into a loss.  The padded head is made in each call, in the one pass
    that casts it; it is differentiable, so a trainable ``wte`` gets the
    gradients of the unpadded product."""
    w = model.wte.weight
    V, D = w.shape
    with annotate("gpt2.lm_head"):
        head = w.new_empty((round_up(V, HEAD_ROW_QUANTUM), D), dtype=hidden.dtype)
        head[:V] = w
        head[V:] = 0
        # One GEMM over all rows: matmul runs a strided 3-D hidden (a loss
        # chunk's slice) as a batched GEMM of a few rows a batch.
        rows = hidden.reshape(-1, D) @ head.t()
        return rows.view(*hidden.shape[:-1], head.shape[0])[..., :V]
