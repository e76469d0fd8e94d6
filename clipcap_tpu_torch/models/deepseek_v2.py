"""DeepSeek-V2 decoder family (DeepSeek-V2-Lite) as ClipCap's language model.

The equations follow DeepSeek's own published ``modeling_deepseek.py``
(DeepSeek-V2, arXiv:2405.04434); :class:`DeepseekV2` holds the weights
under HF ``DeepseekV2ForCausalLM`` state-dict keys, except the routed
experts, which it stacks per layer for the grouped kernel:
``mlp.experts.gate_up_proj`` [E, 2F, D] (gate | up) and
``mlp.experts.down_proj`` [E, D, F] (:func:`dsv2_from_hf` stacks HF's
per-expert keys).

* A pre-norm residual block: ``input_layernorm`` → attention → residual;
  ``post_attention_layernorm`` → SwiGLU MLP (the first
  ``first_k_dense_replace`` layers) or mixture of experts → residual.  Then
  the final ``norm`` and the untied ``lm_head``.  RMSNorm is float32
  inside, its output cast back before the scale, as DeepSeek's.
* Multi-head latent attention (MLA) without a query LoRA: ``q = W_q h`` →
  per head ``q_nope | q_pe``; ``W_kva h`` → the latent ``c`` (rank C) and
  the shared ``k_pe``; ``c ← kv_a_layernorm(c)``; ``W_kvb c`` → per head
  ``k_nope | v``.  RoPE rotates the interleaved pairs of ``q_pe`` and
  ``k_pe`` (DeepSeek's de-interleave, then rotate-half; both sides alike,
  so every score is the published one) with YaRN's inverse frequencies
  (:func:`rope_inv_freq`) and cos/sin scaled by mscale(s, mscale) /
  mscale(s, mscale_all_dim).  The softmax scale is ``q_head_dim^-0.5 ·
  mscale(s, mscale_all_dim)²`` (:func:`softmax_scale`), with mscale(s, m)
  = 0.1·m·ln s + 1.  ``transformers`` 4.57's in-library
  ``DeepseekV2Attention`` leaves the mscale² factor out (its
  ``deepseek_v3`` keeps it); this module keeps DeepSeek's.
* Mixture of experts: float32 router logits ``h·W_gateᵀ``, softmax over
  the routed experts, greedy top-k, weights the unnormalised
  probabilities × ``routed_scaling_factor`` (``norm_topk_prob`` false);
  ``y = Σ_k w_k·SwiGLU_{e_k}(h) + SwiGLU_shared(h)``.  The routed experts
  run grouped by expert (``ops/moe.py``: the CUDA kernel on the card, its
  twin on the CPU).

The latent attention and the mixture of experts serve Kimi-Linear,
Granite-4.0-H and LongCat-Flash too (``models/kimi_linear.py``,
``granite_hybrid.py``, ``longcat_flash.py``): through a config's
:class:`Routing`, sigmoid scoring with a selection bias, renormalised
weights, zero-computation (identity) experts and an expert layer that
holds a share of its experts (expert parallelism: it routes over all of
them and computes the part of the output its own experts give); with no
rope table, attention without rotation (NoPE); with a config's
``q_lora_rank``, a query LoRA (``q_a_proj`` → ``q_a_layernorm`` →
``q_b_proj``) and its ``mla_scales``: q and the normalised latent scaled
after their projections (LongCat-Flash's ``mla_scale_q_lora``,
``mla_scale_kv_lora``), the latent stored scaled.

The cache (:func:`init_latent_cache`) holds per layer one buffer
``[rows, slots, C + r]``: each position's normalised latent and roped
``k_pe``, 576 values at DeepSeek-V2-Lite's widths, in place of GPT-2's
per-head K|V, in the beam layout of ``models/decoding.py``.  Prefill (and
any forward that is not a beam decode step) decompresses K and V from the
latents; a beam
decode step runs absorbed: ``q_lat = q_nope·W_UKᵀ`` per head, scores
against ``[c; k_pe]`` with a float32 softmax, the weighted sum of the
latents, then ``W_UV`` and ``o_proj`` (``ops/mla.py::mla_decode``).

A beam decode step runs as dense segments split at each layer's latent
attention and at each mixture-of-experts layer's grouped expert products
(:func:`_decode_segment`); the cache write, :func:`mla_decode` and
:func:`grouped_expert_mlp` (through :func:`_experts`) run eagerly between
them and are resolved through this module's attributes at each call.  On
the card the segments replay CUDA graphs (``decoding.StepGraphs``, one per
key through the model's ``decode_graphs``); routing (softmax, top-k, the
sort by expert and the offsets) stays on the device inside them, so no
step reads the host.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import math
import os
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clipcap_tpu_torch.models.decoding import (DecodeGraphs, beam_step, causal_bias,
                                              folded_cache_only, slot_cache, softmax_attend)
from clipcap_tpu_torch.ops.layers import Linear, embed, empty_param
from clipcap_tpu_torch.ops.mla import mla_decode
from clipcap_tpu_torch.ops.moe import combine, expert_groups, grouped_expert_mlp
from clipcap_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class YarnScaling:
    """``rope_scaling`` of type ``yarn`` (DeepSeek-V2-Lite's values)."""
    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    norm_topk_prob: bool = False
    routed_scaling_factor: float = 1.0
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[YarnScaling] = YarnScaling()
    max_position_embeddings: int = 163840
    eos_token_id: int = 100001
    name: str = "deepseek-ai/DeepSeek-V2-Lite"

    @property
    def n_embd(self) -> int:
        """The hidden width under GPT-2's name (the mapper's LM width)."""
        return self.hidden_size

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a cache slot holds: the latent and the roped ``k_pe``."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def routing(self) -> "Routing":
        return Routing(self.n_routed_experts, self.num_experts_per_tok, "softmax",
                       self.norm_topk_prob, self.routed_scaling_factor,
                       (0, self.n_routed_experts))

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace and layer % self.moe_layer_freq == 0


@dataclasses.dataclass(frozen=True)
class Routing:
    """A mixture-of-experts layer's router and the experts it holds.

    ``n_experts`` router outputs; the top ``top_k`` by score, ``softmax``
    or ``sigmoid`` (then chosen by score + the layer's per-expert
    ``gate.e_score_correction_bias`` and weighed by the unbiased score, as
    DeepSeek-V3's ``noaux_tc``; softmax with a selection bias where
    ``biased``, as LongCat-Flash's router); the weights renormalised over
    the chosen experts when ``renormalize``, times ``scale``.  The router
    has ``zero_experts`` more outputs after the FFN experts
    (LongCat-Flash's zero-computation experts): an identity expert returns
    the layer's input, weighed like any other, and every chip computes that
    part alike.  The layer computes the FFN experts ``[held[0], held[1])``:
    all of them, or one chip's share under expert parallelism, whose output
    leaves the other FFN experts' part out."""
    n_experts: int
    top_k: int
    scoring: str
    renormalize: bool
    scale: float
    held: Tuple[int, int]
    zero_experts: int = 0
    biased: bool = False

    @property
    def selection_bias(self) -> bool:
        """Whether the top-k is chosen by score + ``e_score_correction_bias``."""
        return self.biased or self.scoring == "sigmoid"

    @property
    def width(self) -> int:
        """The router's outputs: the FFN experts, then the zero-computation ones."""
        return self.n_experts + self.zero_experts

    @property
    def n_held(self) -> int:
        return self.held[1] - self.held[0]

    @property
    def partial(self) -> bool:
        return self.held != (0, self.n_experts)


DSV2_PRESETS: Dict[str, DeepseekV2Config] = {
    # The catalog's row of huggingface.co/deepseek-ai/DeepSeek-V2-Lite config.json;
    # the eos id (100001) from the model's tokenizer config.
    "deepseek-ai/DeepSeek-V2-Lite": DeepseekV2Config(),
    # Test-scale preset (not a published model): every mechanism, tiny widths.
    "deepseek-v2-test": DeepseekV2Config(
        vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=3, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8, n_shared_experts=2,
        num_experts_per_tok=2, max_position_embeddings=512, eos_token_id=1,
        name="deepseek-v2-test"),
}


def _unsupported(what: str):
    raise NotImplementedError(f"DeepSeek-V2 with {what} is not ported (ROADMAP.md, F12)")


def dsv2_config_from_hf(hf: Mapping, name: Optional[str] = None) -> DeepseekV2Config:
    """A config from an HF ``config.json`` dict of ``model_type``
    ``deepseek_v2``; a setting the port does not run raises."""
    checks = [(hf.get("q_lora_rank") is not None, "a query LoRA (q_lora_rank)"),
              (hf.get("topk_method", "greedy") != "greedy", "group-limited routing"),
              (hf.get("scoring_func", "softmax") != "softmax", "a non-softmax router"),
              (hf.get("hidden_act", "silu") != "silu", "an activation other than silu"),
              (bool(hf.get("attention_bias", False)), "attention biases"),
              (bool(hf.get("tie_word_embeddings", False)), "a tied LM head"),
              (hf.get("num_key_value_heads", hf["num_attention_heads"])
               != hf["num_attention_heads"], "grouped key/value heads")]
    for bad, what in checks:
        if bad:
            _unsupported(what)
    rs = hf.get("rope_scaling")
    yarn = None
    if rs is not None:
        if rs.get("type", rs.get("rope_type")) != "yarn":
            _unsupported(f"rope scaling {rs!r}")
        yarn = YarnScaling(
            factor=float(rs["factor"]),
            original_max_position_embeddings=int(rs["original_max_position_embeddings"]),
            beta_fast=float(rs.get("beta_fast", 32)), beta_slow=float(rs.get("beta_slow", 1)),
            mscale=float(rs.get("mscale", 1)), mscale_all_dim=float(rs.get("mscale_all_dim", 0)))
    eos = hf.get("eos_token_id", 100001)
    keys = [f.name for f in dataclasses.fields(DeepseekV2Config)
            if f.name not in ("rope_scaling", "eos_token_id", "name")]
    return DeepseekV2Config(**{k: hf[k] for k in keys if k in hf}, rope_scaling=yarn,
                            eos_token_id=eos if isinstance(eos, int) else eos[0],
                            name=name or hf.get("_name_or_path") or "deepseek-v2-custom")


# ---------------------------------------------------------------------------
# RoPE (YaRN), norms
# ---------------------------------------------------------------------------


def yarn_mscale(scale: float, mscale: float = 1.0) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def rope_inv_freq(cfg: DeepseekV2Config) -> Tensor:
    """Inverse frequencies [r/2] fp32: plain RoPE's, or YaRN's blend of the
    extrapolated and the interpolated ones over DeepSeek's correction range
    (``yarn_find_correction_range(beta_fast, beta_slow, ...)``)."""
    r, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, r, 2, dtype=torch.float32) / r
    extra = 1.0 / base ** exps
    y = cfg.rope_scaling
    if y is None:
        return extra
    inter = 1.0 / (y.factor * base ** exps)

    def dim_of(rotations: float) -> float:
        return (r * math.log(y.original_max_position_embeddings / (rotations * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(dim_of(y.beta_fast)), 0)
    high = min(math.ceil(dim_of(y.beta_slow)), r - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(r // 2, dtype=torch.float32) - low) / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def softmax_scale(cfg: DeepseekV2Config) -> float:
    scale = cfg.q_head_dim ** -0.5
    y = cfg.rope_scaling
    if y is not None and y.mscale_all_dim:
        m = yarn_mscale(y.factor, y.mscale_all_dim)
        scale = scale * m * m
    return scale


def rope_cos_sin(cfg: DeepseekV2Config, positions: Tensor) -> Tensor:
    """``[n, 2, r]`` fp32: cos and sin of ``cat(freqs, freqs)`` at each
    position, times the YaRN attention factor."""
    f = positions.float()[:, None] * rope_inv_freq(cfg).to(positions.device)[None]
    emb = torch.cat([f, f], dim=-1)
    y = cfg.rope_scaling
    a = 1.0 if y is None else yarn_mscale(y.factor, y.mscale) / yarn_mscale(y.factor,
                                                                          y.mscale_all_dim)
    return torch.stack([emb.cos() * a, emb.sin() * a], dim=1)


def apply_rope(x: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """DeepSeek's rotation of the interleaved pairs of ``x`` [..., r]: the
    pairs de-interleaved (evens, then odds), then ``x·cos + rotate_half(x)
    ·sin``; in fp32, cast back to x's dtype.  The output stays in the
    de-interleaved order, as DeepSeek's (queries and keys alike)."""
    r = x.shape[-1]
    y = x.float().unflatten(-1, (r // 2, 2)).transpose(-1, -2).flatten(-2)
    rot = torch.cat([-y[..., r // 2:], y[..., :r // 2]], dim=-1)
    return (y * cos + rot * sin).to(x.dtype)


def rms_norm(x: Tensor, weight: Tensor, eps: float) -> Tensor:
    """DeepSeek's RMSNorm: float32 inside, cast back, then the scale."""
    h = x.float()
    h = h * torch.rsqrt(h.pow(2).mean(-1, keepdim=True) + eps)
    return weight.to(x.dtype) * h.to(x.dtype)


# ---------------------------------------------------------------------------
# Modules (HF keys; the routed experts stacked)
# ---------------------------------------------------------------------------


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.weight = empty_param(dim)
        self.eps = eps

    def forward(self, x: Tensor) -> Tensor:
        return rms_norm(x, self.weight, self.eps)


class _MLA(nn.Module):
    """The latent attention's projections: ``q_proj``, or with the config's
    ``q_lora_rank`` the query LoRA ``q_a_proj`` → ``q_a_layernorm`` →
    ``q_b_proj``; the scales of q and of the normalised latent
    (``cfg.mla_scales``, None: 1) as plain attributes."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        D, H = cfg.hidden_size, cfg.num_attention_heads
        q_lora = getattr(cfg, "q_lora_rank", None)
        if q_lora:
            self.q_a_proj = Linear(D, q_lora, bias=False)
            self.q_a_layernorm = RMSNorm(q_lora)
            self.q_b_proj = Linear(q_lora, H * cfg.q_head_dim, bias=False)
        else:
            self.q_proj = Linear(D, H * cfg.q_head_dim, bias=False)
        self.q_scale, self.kv_scale = getattr(cfg, "mla_scales", None) or (None, None)
        self.kv_a_proj_with_mqa = Linear(D, cfg.latent_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank)
        self.kv_b_proj = Linear(cfg.kv_lora_rank,
                                H * (cfg.qk_nope_head_dim + cfg.v_head_dim), bias=False)
        self.o_proj = Linear(H * cfg.v_head_dim, D, bias=False)


class _MLP(nn.Module):
    """SwiGLU: ``down(silu(gate(x)) · up(x))``."""

    def __init__(self, d: int, f: int):
        super().__init__()
        self.gate_proj = Linear(d, f, bias=False)
        self.up_proj = Linear(d, f, bias=False)
        self.down_proj = Linear(f, d, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class _MoE(nn.Module):
    """The router over all ``routing.n_experts``, the held experts stacked
    (local index e is expert ``held[0] + e``), the shared experts."""

    def __init__(self, cfg):
        super().__init__()
        r = cfg.routing
        D, Fw = cfg.hidden_size, cfg.moe_intermediate_size
        self.gate = nn.Module()
        self.gate.weight = empty_param(r.width, D)
        if r.selection_bias:
            self.gate.e_score_correction_bias = empty_param(r.width)
        self.experts = nn.Module()
        self.experts.gate_up_proj = empty_param(r.n_held, 2 * Fw, D)
        self.experts.down_proj = empty_param(r.n_held, D, Fw)
        self.shared_experts = _MLP(D, Fw * cfg.n_shared_experts)


class _Layer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = _MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = _MoE(cfg) if cfg.is_moe(i) else _MLP(cfg.hidden_size, cfg.intermediate_size)


class DeepseekV2(nn.Module):
    """DeepSeek-V2 weights under HF ``DeepseekV2ForCausalLM`` keys (experts
    stacked).  Built empty: weights come from :func:`init_dsv2`,
    :func:`dsv2_from_hf` or ``load_state_dict(assign=True)``."""

    roadmap_item = "F12"       # what the port does not run with it yet

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.config = cfg
        self.model = nn.Module()
        self.model.embed_tokens = nn.Module()
        self.model.embed_tokens.weight = empty_param(cfg.vocab_size, cfg.hidden_size)
        self.model.layers = nn.ModuleList(_Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.model.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Module()
        self.lm_head.weight = empty_param(cfg.vocab_size, cfg.hidden_size)
        # A beam decode step's eager work, in order: each layer's latent
        # attention, then its grouped experts where it has them.
        self.cuts: List[Tuple[str, int]] = []
        for i in range(cfg.num_hidden_layers):
            self.cuts += [("attn", i)] + ([("moe", i)] if cfg.is_moe(i) else [])
        self.decode_graphs = DecodeGraphs()
        self._rope: Dict[torch.device, Tensor] = {}

    @property
    def decode_segments(self) -> int:
        """Dense segments of a beam decode step (:func:`_decode_segment`)."""
        return len(self.cuts) + 1

    def decode_tensors(self):
        """The tensors the segments read: the layers' and the final norm's."""
        return (*self.model.layers.parameters(), *self.model.layers.buffers(),
                *self.model.norm.parameters())

    def rope_rows(self, n: int, device) -> Tensor:
        """The cos/sin table ``[≥ n, 2, r]`` on ``device``, grown on demand."""
        device = torch.device(device)
        table = self._rope.get(device)
        if table is None or table.shape[0] < n:
            size = max(n, 128, 0 if table is None else 2 * table.shape[0])
            table = rope_cos_sin(self.config, torch.arange(size, device=device))
            self._rope[device] = table
        return table


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_dsv2(cfg: DeepseekV2Config, seed: int = 0) -> DeepseekV2:
    """Seeded fp32 weights on the CPU: every matrix N(0, 0.02), norm scales 1."""
    model = DeepseekV2(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return model


def dsv2_from_state_dict(sd: Mapping[str, Tensor], cfg: DeepseekV2Config) -> DeepseekV2:
    """A model holding the tensors of ``sd`` (the port's keys) as they are."""
    with torch.device("meta"):
        model = DeepseekV2(cfg)
    model.load_state_dict(dict(sd), strict=True, assign=True)
    return model


def dsv2_from_hf(state_dict: Mapping[str, Tensor], cfg: DeepseekV2Config) -> DeepseekV2:
    """A model from an HF ``DeepseekV2ForCausalLM`` state dict: each MoE
    layer's per-expert ``mlp.experts.{e}.{gate,up,down}_proj.weight`` are
    stacked into ``gate_up_proj`` [E, 2F, D] and ``down_proj`` [E, D, F]."""
    sd = {k: v.detach() for k, v in state_dict.items()}
    for i in range(cfg.num_hidden_layers):
        if not cfg.is_moe(i):
            continue
        p = f"model.layers.{i}.mlp.experts."
        per = [[sd.pop(f"{p}{e}.{n}_proj.weight") for n in ("gate", "up", "down")]
               for e in range(cfg.n_routed_experts)]
        sd[p + "gate_up_proj"] = torch.stack([torch.cat([g, u]) for g, u, _ in per])
        sd[p + "down_proj"] = torch.stack([d for _, _, d in per])
    return dsv2_from_state_dict(sd, cfg)


def load_dsv2(name_or_path: str) -> DeepseekV2:
    """Resolve a DeepSeek-V2 without the network: a local directory with an
    HF ``config.json`` and ``*.safetensors`` weights; else, for a preset
    name, seeded weights (:func:`init_dsv2`, seed 0) with a warning."""
    from clipcap_tpu_torch.models.hf_import import load_torch_state_dict

    if os.path.isdir(name_or_path):
        with open(os.path.join(name_or_path, "config.json")) as f:
            cfg = dsv2_config_from_hf(json.load(f), name=name_or_path)
        files = sorted(glob.glob(os.path.join(name_or_path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no weights file in {name_or_path}")
        sd = {}
        for path in files:
            sd.update(load_torch_state_dict(path))
        return dsv2_from_hf(sd, cfg)
    if name_or_path in DSV2_PRESETS:
        if name_or_path != "deepseek-v2-test":
            warnings.warn(
                f"No pretrained weights for '{name_or_path}' on disk. Using RANDOM "
                "initialization — fine for benchmarks, wrong for pretrained captioning.")
        return init_dsv2(DSV2_PRESETS[name_or_path], seed=0)
    raise ValueError(f"cannot resolve language model '{name_or_path}'")


def is_dsv2(name_or_path: str) -> bool:
    """Whether a language-model name or directory is of this family."""
    if name_or_path in DSV2_PRESETS:
        return True
    cfg = os.path.join(name_or_path, "config.json")
    if os.path.isdir(name_or_path) and os.path.exists(cfg):
        with open(cfg) as f:
            return json.load(f).get("model_type") == "deepseek_v2"
    return False


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------


def init_latent_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                      beam_size: Optional[int] = None, prefix_slots: int = 0,
                      device="cpu") -> List[Tensor]:
    """Zeroed per-layer latent caches ``[rows, slots, C + r]``
    (``decoding.slot_cache``: plain, or ``beam_size`` beams with the folded
    prefix in slots ``[0, prefix_slots)``)."""
    return [slot_cache(batch, max_len, cfg.latent_dim, dtype, beam_size, prefix_slots, device)
            for _ in range(cfg.num_hidden_layers)]


def dsv2_beam_cache(cfg: DeepseekV2Config, bp, groups: int, prefix_len: int, tile_major: bool,
                    dtype, device) -> Tuple[List[Tensor], None]:
    """``gpt2.gpt2_beam_cache``'s contract with the folded-prefix latent cache
    alone: the other forms raise before anything is allocated."""
    what = folded_cache_only(bp, tile_major)
    if what:
        _unsupported(f"{what} in beam search")
    return init_latent_cache(cfg, groups * bp.beam_size, bp.max_new_tokens, dtype,
                             bp.beam_size, prefix_len, device), None


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _project(attn: _MLA, h: Tensor, cfg, rope: Optional[Tensor]):
    """``h`` [B, S, D] (normalised) → ``q_nope`` [B, S, H, nope], roped
    ``q_pe`` [B, S, H, r], normalised ``c`` [B, S, C], roped ``k_pe``
    [B, S, r]; ``rope`` [S, 2, r], or None where the config uses no
    rotation (NoPE: ``q_pe`` and ``k_pe`` as projected)."""
    B, S, _ = h.shape
    H, r = cfg.num_attention_heads, cfg.qk_rope_head_dim
    if hasattr(attn, "q_proj"):
        q = attn.q_proj(h)
    else:
        q = attn.q_b_proj(attn.q_a_layernorm(attn.q_a_proj(h)))
    if attn.q_scale is not None:
        q = q * attn.q_scale
    q_nope, q_pe = q.view(B, S, H, cfg.q_head_dim).split([cfg.qk_nope_head_dim, r], dim=-1)
    c, k_pe = attn.kv_a_proj_with_mqa(h).split([cfg.kv_lora_rank, r], dim=-1)
    c = attn.kv_a_layernorm(c)
    if attn.kv_scale is not None:
        c = c * attn.kv_scale
    if rope is None:
        return q_nope, q_pe, c, k_pe
    cos, sin = rope[:, 0], rope[:, 1]
    return q_nope, apply_rope(q_pe, cos[:, None], sin[:, None]), c, apply_rope(k_pe, cos, sin)


def _w_kv_b(attn: _MLA, cfg, dtype) -> Tensor:
    """``kv_b_proj``'s weight per head: ``[H, nope + v, C]`` (W_UK | W_UV)."""
    return attn.kv_b_proj.weight.to(dtype).view(
        cfg.num_attention_heads, cfg.qk_nope_head_dim + cfg.v_head_dim, cfg.kv_lora_rank)


def _attend(attn: _MLA, h: Tensor, cfg, rope: Optional[Tensor], bias: Tensor,
            cache: Optional[Tensor], offset: int) -> Tensor:
    """Attention of positions ``[offset, offset + S)`` with K and V
    decompressed from the latents: over the input alone (no cache), or
    over the cache's slots ``[0, offset + S)`` after writing the input's
    rows there.  → ``o_proj``'s output [B, S, D]."""
    B, S, _ = h.shape
    H, nope, vd = cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.v_head_dim
    q_nope, q_pe, c, k_pe = _project(attn, h, cfg, rope)
    if cache is not None:
        cache[:, offset:offset + S] = torch.cat([c, k_pe], dim=-1)
        c, k_pe = cache[:, :offset + S].split([cfg.kv_lora_rank, cfg.qk_rope_head_dim], dim=-1)
    T = c.shape[1]
    k_nope, v = attn.kv_b_proj(c).view(B, T, H, nope + vd).split([nope, vd], dim=-1)
    q = torch.cat([q_nope, q_pe], dim=-1).transpose(1, 2)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, T, H, -1)], dim=-1).transpose(1, 2)
    o = softmax_attend(q, k, v.transpose(1, 2), bias, softmax_scale(cfg))
    return attn.o_proj(o.transpose(1, 2).reshape(B, S, H * vd))


def _route(moe: _MoE, h: Tensor, cfg) -> Tuple[Tensor, Tensor]:
    """``h`` [T, D] → (weights [T, k] fp32, global expert ids [T, k]):
    float32 logits over the router's width, then ``cfg.routing``'s
    scoring, top-k and weighting."""
    r = cfg.routing
    logits = h.float() @ moe.gate.weight.float().t()
    scores = logits.sigmoid() if r.scoring == "sigmoid" else logits.softmax(dim=-1)
    if r.selection_bias:
        bias = moe.gate.e_score_correction_bias.float()
        idx = torch.topk(scores + bias, r.top_k, dim=-1).indices
        w = scores.gather(-1, idx)
    else:
        w, idx = torch.topk(scores, r.top_k, dim=-1)
    if r.renormalize and r.top_k > 1:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return w * r.scale, idx


def _dispatch(moe: _MoE, h: Tensor, cfg):
    """Routing of ``h`` [T, D] → the pairs' rows sorted by expert, the FFN
    experts' offsets [E + 1] (local ids), the inverse order and the
    weights.  A layer that holds a share of the experts renumbers them so
    its own come first (``held[0]`` → 0): its ``n_held`` experts' rows end
    at ``offsets[n_held]``; the other FFN pairs' rows follow, never
    computed, then, from ``offsets[E]``, the zero-computation pairs' (ids
    past every FFN expert), whose rows are the input itself.  Every step
    keeps T·k rows."""
    r = cfg.routing
    w, idx = _route(moe, h, cfg)
    if r.partial and r.zero_experts:
        idx = torch.where(idx < r.n_experts, (idx - r.held[0]) % r.n_experts, idx)
    elif r.partial:
        idx = (idx - r.held[0]) % r.n_experts
    order, inv, offsets = expert_groups(idx, r.n_experts)
    return h.index_select(0, order // r.top_k), offsets, inv, w


def _experts(moe, rows: Tensor, offsets: Tensor) -> Tensor:
    """The held experts' SwiGLU over the sorted rows: this module's
    :func:`grouped_expert_mlp` with the held experts' offsets ``offsets[:
    n_held + 1]``, in the span ``moe.experts`` (the prefill's and each
    decode step's call)."""
    experts = moe.experts
    held = offsets[:experts.gate_up_proj.shape[0] + 1]
    with annotate("moe.experts"):
        return grouped_expert_mlp(rows, experts.gate_up_proj, experts.down_proj, held)


def _combine(y: Tensor, offsets: Tensor, inv: Tensor, w: Tensor, cfg,
             rows: Optional[Tensor] = None) -> Tensor:
    """``combine`` of the grouped output; a layer holding a share of the
    experts zeroes the rows of the pairs routed elsewhere first (never
    written), so their weights add nothing; a router with zero-computation
    experts takes those pairs' ``rows`` (the input) as their output."""
    r = cfg.routing
    if r.partial or r.zero_experts:
        row = torch.arange(y.shape[0], device=y.device)
        y = y.masked_fill(~(row < offsets[r.n_held])[:, None], 0)
        if r.zero_experts:
            y = torch.where((row >= offsets[r.n_experts])[:, None], rows, y)
    return combine(y, inv, w)


def _routed(moe, h2: Tensor, cfg) -> Tensor:
    """The routed experts' part of an expert layer's output for ``h2``
    [T, D]: the held experts' and the zero-computation experts'."""
    xs, offsets, inv, w = _dispatch(moe, h2, cfg)
    return _combine(_experts(moe, xs, offsets), offsets, inv, w, cfg, xs)


def _moe(moe: _MoE, h: Tensor, cfg) -> Tensor:
    shape = h.shape
    h2 = h.reshape(-1, shape[-1])
    return (_routed(moe, h2, cfg) + moe.shared_experts(h2)).view(shape)


# -- beam decode steps: dense segments between the eager work ---------------
#
# Segment 0 is layer 0's attention prologue (``input_layernorm``, the
# projections, RoPE, the absorbed query, the cache row).  Segment j > 0
# follows the j-th cut (``model.cuts``): after a layer's latent attention,
# ``W_UV``, ``o_proj`` and the residual, ``post_attention_layernorm``, then
# either the dense MLP and the next prologue, or the routing, the sort by
# expert and the shared experts; after a layer's grouped experts, the
# weighted sum, the residual, then the next prologue.  The last ends in the
# final norm.  A segment's outputs (its carry): ``(x, rope, q, row)`` before
# a latent attention, ``(x, rope, rows, offsets, inv, weights, shared)``
# before the experts, ``(hidden,)`` at the end.  With a shortcut (LongCat-
# Flash's ScMoE) an expert layer's shared part joins the residual after
# the experts, and its routed part rides at the end of the carries across
# the next layer, which adds it after its MLP.


def _prologue(model: nn.Module, i: int, x: Tensor, rope: Optional[Tensor], K: int) -> tuple:
    """Layer ``i``'s latent-attention prologue: ``(x, rope, q, row)``."""
    return _mla_prologue(model.model.layers[i], model.config, x, rope, K)


def _mla_prologue(layer, cfg, x: Tensor, rope: Optional[Tensor], K: int) -> tuple:
    """A layer's latent-attention prologue (``input_layernorm``, the
    projections, RoPE, the absorbed query, the cache row): ``(x, rope, q,
    row)``."""
    B = x.shape[0]
    q_nope, q_pe, c, k_pe = _project(layer.self_attn, layer.input_layernorm(x), cfg, rope)
    w_uk = _w_kv_b(layer.self_attn, cfg, x.dtype)[:, :cfg.qk_nope_head_dim]
    q_lat = torch.einsum("bhd,hdc->bhc", q_nope[:, 0], w_uk)
    q = torch.cat([q_lat, q_pe[:, 0]], dim=-1).view(B // K, K, cfg.num_attention_heads, -1)
    return x, rope, q, torch.cat([c, k_pe], dim=-1).view(B // K, K, -1)


def _mla_out(layer: nn.Module, kind: str, out: Tensor, carry: tuple, cfg, K: int) -> Tensor:
    """A latent attention's output ``out`` [R, K, H, C] → ``W_UV``, ``o_proj``."""
    R, _, H, C = out.shape
    w_uv = _w_kv_b(layer.self_attn, cfg, out.dtype)[:, cfg.qk_nope_head_dim:]
    o = torch.einsum("bhc,hvc->bhv", out.reshape(R * K, H, C), w_uv)
    return layer.self_attn.o_proj(o.reshape(R * K, 1, H * cfg.v_head_dim))


def _decode_segment(model: nn.Module, j: int, carry: Optional[tuple], inputs: tuple, K: int,
                    prologue=_prologue, mixer_out=_mla_out,
                    residual: Optional[float] = None, layers=None,
                    shortcut: bool = False) -> tuple:
    """Segment ``j`` of a beam decode step.  A family with other token
    mixers than latent attention passes its own ``prologue`` (layer i's
    carry before its eager work) and ``mixer_out`` (that work's output →
    the residual branch); one that scales each residual branch before the
    add (Granite's ``residual_multiplier``) passes the factor; one whose
    cuts index other layers than ``model.model.layers`` (LongCat-Flash's
    halves of a double layer) passes them.  With ``shortcut`` an expert
    layer adds only its shared part (LongCat-Flash: the dense ``mlps[0]``)
    to the residual; its routed part is carried, last, through the next
    layer's segments and added after that layer's MLP (ScMoE)."""
    def add(x: Tensor, branch: Tensor) -> Tensor:
        return x + (branch if residual is None else branch * residual)

    cfg = model.config
    if j == 0:                          # (x, rope), or (x,) in a family without rotation
        x, rope = inputs[0], inputs[1] if len(inputs) > 1 else None
        return prologue(model, 0, x, rope, K)
    kind, i = model.cuts[j - 1]
    layer = (model.model.layers if layers is None else layers)[i]
    (out,) = inputs
    x, rope = carry[0], carry[1]
    if kind == "moe":
        offsets, inv, w, shared = carry[3:]
        routed = _combine(out, offsets, inv, w, cfg, carry[2])
        if shortcut:
            x = add(x, shared.view_as(x))
            return (*prologue(model, i + 1, x, rope, K), routed.view_as(x))
        x = add(x, (routed + shared).view_as(x))
    else:
        x = add(x, mixer_out(layer, kind, out, carry, cfg, K))
        h = layer.post_attention_layernorm(x)
        if cfg.is_moe(i):
            h2 = h.reshape(-1, cfg.hidden_size)
            return (x, rope, *_dispatch(layer.mlp, h2, cfg), layer.mlp.shared_experts(h2))
        x = add(x, layer.mlp(h))
        if shortcut and i > 0 and cfg.is_moe(i - 1):
            x = x + carry[-1]
    if i + 1 == cfg.num_hidden_layers:
        return (model.model.norm(x),)
    return prologue(model, i + 1, x, rope, K)


def _eager_attn(cache: Tensor, carry: tuple, mask: Tensor, slot: int, K: int, cfg) -> Tensor:
    """A latent attention's eager work: the K rows' latents into the cache
    at ``slot``, then :func:`mla_decode` (this module's attribute)."""
    cache[:, slot:slot + K] = carry[3]
    with annotate("mla.decode"):
        return mla_decode(carry[2], cache, mask, slot + K, softmax_scale(cfg), cfg.kv_lora_rank)


def _eager_experts(layer: nn.Module, carry: tuple) -> Tensor:
    """An expert layer's eager work: :func:`_experts` (this module's
    attribute) over the sorted rows and the FFN experts' offsets."""
    return _experts(layer.mlp, carry[2], carry[3])


def _beam_decode_layers(model: DeepseekV2, x: Tensor, kv_cache: List[Tensor], mask: Tensor,
                        slot: int, K: int, rope: Tensor, steps) -> Tensor:
    """The layers and final norm of one beam decode step → the hidden state
    [B, 1, D]: the segments run through ``steps``; each layer's cache write and
    latent attention, and each MoE layer's grouped experts, eagerly between them."""
    def segment(j, carry, *inputs):
        return _decode_segment(model, j, carry, inputs, K)

    carry = steps.run(segment, 0, x, rope)
    for j, (kind, i) in enumerate(model.cuts):
        if kind == "attn":
            out = _eager_attn(kv_cache[i], carry, mask, slot, K, model.config)
        else:
            out = _eager_experts(model.model.layers[i], carry)
        carry = steps.run(segment, j + 1, out)
    return carry[0]


def dsv2_apply(model: DeepseekV2, *, input_ids: Optional[Tensor] = None,
               inputs_embeds: Optional[Tensor] = None,
               kv_cache: Optional[List[Tensor]] = None, cache_index: int = 0,
               dtype=torch.float32, return_logits: bool = True,
               beam_size: Optional[int] = None, ancestry: Optional[Tensor] = None,
               cache_base: int = 0, shared_kv=None, shared_len=None, graphs=None):
    """DeepSeek-V2 forward → ``(logits_or_hidden, kv_cache)``, with
    ``gpt2.gpt2_apply``'s arguments.

    ``kv_cache=None``: causal attention over the input.  Cached, without ``ancestry``: the input's
    latent rows are written at slots ``[cache_index, cache_index + S)`` and
    attention reads the slots ``[0, cache_index + S)`` (the prefill, and
    plain decoding).  Beam decode (``beam_size`` K, ``ancestry`` [B, Tl],
    ``cache_base`` P, one token): the absorbed step over the folded beam
    cache, its segments run as ``gpt2_apply``'s.  The consolidated shared
    prefix (``shared_kv``) and the replicated beam prefill raise
    ``NotImplementedError``.
    """
    cfg = model.config
    if shared_kv is not None or shared_len is not None:
        _unsupported("a consolidated shared-prefix cache")
    if inputs_embeds is None:
        inputs_embeds = embed(model.model.embed_tokens.weight, input_ids, dtype)
    x = inputs_embeds.to(dtype)
    B, S, _ = x.shape
    dev = x.device
    offset = cache_index if kv_cache is not None else 0
    if S > 1 and offset != 0:
        raise ValueError("cached prefill (S > 1) requires cache_index == 0")
    rope = model.rope_rows(offset + S, dev)[offset:offset + S]           # [S, 2, r]

    if kv_cache is not None and ancestry is not None:
        with beam_step("dsv2.blocks", x, ancestry, beam_size, kv_cache[0].shape[1], offset,
                       cache_base, graphs) as (mask, slot, steps):
            x = _beam_decode_layers(model, x, kv_cache, mask, slot, beam_size, rope, steps)
        return (dsv2_logits(model, x) if return_logits else x), kv_cache
    if graphs is not None:
        raise ValueError("graphs serve beam decode steps only (ancestry and one token)")
    if beam_size is not None:
        _unsupported("a replicated beam prefix (fold_prefix=False)")

    bias = causal_bias(S, offset + S, offset, device=dev)
    with annotate("dsv2.blocks"):
        for i, layer in enumerate(model.model.layers):
            h = layer.input_layernorm(x)
            x = x + _attend(layer.self_attn, h, cfg, rope, bias,
                            None if kv_cache is None else kv_cache[i], offset)
            h = layer.post_attention_layernorm(x)
            x = x + (_moe(layer.mlp, h, cfg) if cfg.is_moe(i) else layer.mlp(h))
    x = model.model.norm(x)
    return (dsv2_logits(model, x) if return_logits else x), kv_cache


def dsv2_embed_tokens(model: DeepseekV2, token_ids: Tensor, dtype=torch.float32) -> Tensor:
    return embed(model.model.embed_tokens.weight, token_ids, dtype)


def dsv2_logits(model: DeepseekV2, hidden: Tensor) -> Tensor:
    """Project hidden states onto the vocabulary (the untied ``lm_head``)."""
    with annotate("dsv2.lm_head"):
        return hidden @ model.lm_head.weight.to(hidden.dtype).t()
