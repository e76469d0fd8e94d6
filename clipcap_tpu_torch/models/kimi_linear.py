"""Kimi-Linear decoder family (Kimi-Linear-48B-A3B) as ClipCap's language model.

The equations follow the Kimi Linear technical report (arXiv:2510.26692)
and the flash-linear-attention ``KimiDeltaAttention`` layer that the
published modelling code calls.  :class:`KimiLinear` holds the weights
under the port's own names, as ``models/deepseek_v2.py`` does (the routed
experts stacked: ``mlp.experts.gate_up_proj`` [E_held, 2F, D], gate | up,
and ``mlp.experts.down_proj`` [E_held, D, F]).

* A pre-norm residual block: ``input_layernorm`` → KDA or MLA → residual;
  ``post_attention_layernorm`` → SwiGLU MLP (the first
  ``first_k_dense_replace`` layers) or mixture of experts → residual; the
  final ``norm`` and the untied ``lm_head``.  3 KDA layers : 1 MLA layer,
  at the 1-based indices of ``linear_attn_config``.
* KDA (Kimi Delta Attention, a gated delta rule), for the normalised ``h``,
  H heads of d: ``q, k, v = SiLU(conv4(W h))`` (causal depthwise
  convolutions of kernel 4 over H·d channels); q, k L2-normalised per head,
  q scaled by d^-1/2; ``β = sigmoid(W_b h)`` [H]; the per-channel log decay
  ``g = −exp(A_log) ⊙ softplus(W_fb W_fa h + dt_bias)`` [H, d]; per head,
  the float32 state S ∈ ℝ^{d×d} from zero: ``S ← Diag(exp g) S``, ``S ← S +
  β k (v − Sᵀk)ᵀ``, ``o = Sᵀq``; then ``RMSNorm_d(o) ⊙ w ⊙ sigmoid(W_gb W_ga
  h + b_g)`` and ``W_o``.  The step is ``ops/kda.py::kda_decode`` (the CUDA
  kernel on the card, its twin on the CPU), which also moves the
  convolutions' windows.
* MLA as DeepSeek-V2's (``deepseek_v2._MLA``, ``_attend``, the absorbed
  ``mla_decode``) with no rotation (``mla_use_nope``): softmax scale
  ``(nope + rope)^-0.5``.
* The mixture of experts as DeepSeek-V2's layer with ``Routing``: sigmoid
  scores, top-8 by score + ``e_score_correction_bias``, weights the
  unbiased scores renormalised × ``routed_scaling_factor``, one shared
  expert.  The layer holds the experts ``experts_held`` (expert
  parallelism: one chip's share); it routes over all ``num_experts`` and
  adds the held experts' part.

The beam cache (``decoding.HybridCache``) holds, beside a latent cache per
MLA layer in the beam layout of ``models/decoding.py`` (slots never move), two
float32 state buffers ``[B, H, d, d]`` and two convolution windows ``[B, 3,
3, H·d]`` per KDA layer: the step at position t reads buffer t % 2 of each
row's parent (``decoding.beam_parent``) and writes buffer (t + 1) % 2 of
the row.  The prefill over the prefix runs once per sample, into rows
``[0, R)``, stepping the same kernel token by token.

A beam decode step runs as dense segments split at each layer's KDA step
or latent attention and at each expert layer's grouped products
(``deepseek_v2._decode_segment`` with this family's prologue); the KDA
kernel, the latent-cache write with ``mla_decode`` and the grouped experts
run eagerly between them, the last two through ``models.deepseek_v2``'s
attributes.  On the card the segments replay CUDA graphs; the parent
index and the routing stay on the device.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from clipcap_tpu_torch.models import deepseek_v2 as dsv2
from clipcap_tpu_torch.models.decoding import (DecodeGraphs, HybridCache, beam_parent, beam_step,
                                              causal_bias, folded_cache_only, init_hybrid_cache)
from clipcap_tpu_torch.models.deepseek_v2 import _MLA, _MLP, RMSNorm, Routing, _MoE
from clipcap_tpu_torch.ops.kda import CONV_TAPS, kda_decode
from clipcap_tpu_torch.ops.layers import Linear, embed, empty_param
from clipcap_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

# The published layer pattern (1-based): three KDA layers, then one MLA.
KDA_LAYERS = (1, 2, 3, 5, 6, 7, 9, 10, 11, 13, 14, 15, 17, 18, 19, 21, 22, 23, 25, 26)
FULL_ATTN_LAYERS = (4, 8, 12, 16, 20, 24, 27)


@dataclasses.dataclass(frozen=True)
class LinearAttnConfig:
    """``linear_attn_config``: the KDA layers (1-based), their heads, head
    size and short-convolution kernel."""
    kda_layers: Tuple[int, ...] = KDA_LAYERS
    full_attn_layers: Tuple[int, ...] = FULL_ATTN_LAYERS
    head_dim: int = 128
    num_heads: int = 32
    short_conv_kernel_size: int = 4


@dataclasses.dataclass(frozen=True)
class KimiLinearConfig:
    """The published ``config.json`` keys the model reads, plus the experts
    this chip holds (``experts_held``, expert parallelism) and the eos id."""
    vocab_size: int = 163840
    hidden_size: int = 2304
    intermediate_size: int = 9216
    moe_intermediate_size: int = 1024
    num_hidden_layers: int = 27
    num_attention_heads: int = 32
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    num_experts: int = 256
    num_experts_per_token: int = 8
    num_shared_experts: int = 1
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    moe_renormalize: bool = True
    moe_router_activation_func: str = "sigmoid"
    routed_scaling_factor: float = 2.446
    rms_norm_eps: float = 1e-5
    linear_attn_config: LinearAttnConfig = LinearAttnConfig()
    experts_held: Tuple[int, int] = (0, 256)
    eos_token_id: int = 163586
    name: str = "moonshotai/Kimi-Linear-48B-A3B-Instruct"

    rope_scaling = None           # NoPE: the MLA layers rotate nothing

    @property
    def n_embd(self) -> int:
        """The hidden width under GPT-2's name (the mapper's LM width)."""
        return self.hidden_size

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def n_shared_experts(self) -> int:
        return self.num_shared_experts

    @property
    def routing(self) -> Routing:
        return Routing(self.num_experts, self.num_experts_per_token,
                       self.moe_router_activation_func, self.moe_renormalize,
                       self.routed_scaling_factor, tuple(self.experts_held))

    def is_moe(self, layer: int) -> bool:
        return layer >= self.first_k_dense_replace and layer % self.moe_layer_freq == 0

    def is_kda(self, layer: int) -> bool:
        return layer + 1 in self.linear_attn_config.kda_layers


KIMI_PRESETS: Dict[str, KimiLinearConfig] = {
    # The catalog's row of huggingface.co/moonshotai/Kimi-Linear-48B-A3B-Instruct
    # config.json, holding experts 0-31 of 256: one chip's share under expert
    # parallelism 8.  The eos id is assumed (the catalog strips it).
    "moonshotai/Kimi-Linear-48B-A3B-Instruct": KimiLinearConfig(experts_held=(0, 32)),
    # Test-scale preset (not a published model): every mechanism, tiny widths.
    "kimi-linear-test": KimiLinearConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128, moe_intermediate_size=32,
        num_hidden_layers=4, num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16, num_experts=8, num_experts_per_token=3,
        linear_attn_config=LinearAttnConfig(kda_layers=(1, 2, 4), full_attn_layers=(3,),
                                             head_dim=16, num_heads=2),
        experts_held=(0, 8), eos_token_id=1, name="kimi-linear-test"),
}


def _unsupported(what: str):
    raise NotImplementedError(f"Kimi-Linear with {what} is not ported "
                              f"(ROADMAP.md, {KimiLinear.roadmap_item})")


def kimi_config_from_hf(hf: Mapping, experts_held: Optional[Tuple[int, int]] = None,
                        name: Optional[str] = None) -> KimiLinearConfig:
    """A config from a ``config.json`` dict of ``model_type`` ``kimi_linear``
    (the held experts default to all); a setting the port does not run
    raises."""
    checks = [(hf.get("q_lora_rank") is not None, "a query LoRA (q_lora_rank)"),
              (not hf.get("mla_use_nope", False), "rotary MLA (mla_use_nope false)"),
              (hf.get("num_expert_group", 1) != 1, "group-limited routing"),
              (hf.get("moe_router_activation_func", "sigmoid") not in ("sigmoid", "softmax"),
               f"a {hf.get('moe_router_activation_func')} router"),
              (hf.get("hidden_act", "silu") != "silu", "an activation other than silu"),
              (bool(hf.get("tie_word_embeddings", False)), "a tied LM head"),
              (hf.get("rope_scaling") is not None, "rope scaling"),
              (hf.get("num_key_value_heads", hf["num_attention_heads"])
               != hf["num_attention_heads"], "grouped key/value heads")]
    for bad, what in checks:
        if bad:
            _unsupported(what)
    la = hf["linear_attn_config"]
    lin = LinearAttnConfig(kda_layers=tuple(la["kda_layers"]),
                           full_attn_layers=tuple(la["full_attn_layers"]),
                           head_dim=la["head_dim"], num_heads=la["num_heads"],
                           short_conv_kernel_size=la["short_conv_kernel_size"])
    if lin.short_conv_kernel_size != CONV_TAPS:
        _unsupported(f"a short convolution of kernel {lin.short_conv_kernel_size}")
    keys = [f.name for f in dataclasses.fields(KimiLinearConfig)
            if f.name not in ("linear_attn_config", "experts_held", "eos_token_id", "name")]
    eos = hf.get("eos_token_id", KimiLinearConfig.eos_token_id)
    return KimiLinearConfig(**{k: hf[k] for k in keys if k in hf}, linear_attn_config=lin,
                            experts_held=tuple(experts_held or (0, hf["num_experts"])),
                            eos_token_id=eos if isinstance(eos, int) else eos[0],
                            name=name or hf.get("_name_or_path") or "kimi-linear-custom")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class _KDA(nn.Module):
    """A KDA layer's weights under flash-linear-attention's names; the
    convolutions' ``weight`` [H·d, 1, 4] as ``nn.Conv1d``'s (no bias)."""

    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        la = cfg.linear_attn_config
        D, H, d = cfg.hidden_size, la.num_heads, la.head_dim
        HD = H * d
        self.q_proj = Linear(D, HD, bias=False)
        self.k_proj = Linear(D, HD, bias=False)
        self.v_proj = Linear(D, HD, bias=False)
        for n in ("q", "k", "v"):
            conv = nn.Module()
            conv.weight = empty_param(HD, 1, la.short_conv_kernel_size)
            setattr(self, f"{n}_conv1d", conv)
        self.A_log = empty_param(H)
        self.f_a_proj = Linear(D, d, bias=False)
        self.f_b_proj = Linear(d, HD, bias=False)
        self.dt_bias = empty_param(HD)
        self.b_proj = Linear(D, H, bias=False)
        self.g_a_proj = Linear(D, d, bias=False)
        self.g_b_proj = Linear(d, HD, bias=True)
        self.o_norm = RMSNorm(d, cfg.rms_norm_eps)
        self.o_proj = Linear(HD, D, bias=False)


class _Layer(nn.Module):
    def __init__(self, cfg: KimiLinearConfig, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = _KDA(cfg) if cfg.is_kda(i) else _MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = _MoE(cfg) if cfg.is_moe(i) else _MLP(cfg.hidden_size, cfg.intermediate_size)


class KimiLinear(nn.Module):
    """Kimi-Linear weights (experts stacked, the held share only).  Built
    empty: weights come from :func:`init_kimi` or
    ``load_state_dict(assign=True)``."""

    roadmap_item = "F13"       # what the port does not run with it yet

    def __init__(self, cfg: KimiLinearConfig):
        super().__init__()
        self.config = cfg
        self.model = nn.Module()
        self.model.embed_tokens = nn.Module()
        self.model.embed_tokens.weight = empty_param(cfg.vocab_size, cfg.hidden_size)
        self.model.layers = nn.ModuleList(_Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.model.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Module()
        self.lm_head.weight = empty_param(cfg.vocab_size, cfg.hidden_size)
        # A beam decode step's eager work, in order: each layer's KDA step or
        # latent attention, then its grouped experts where it has them.
        self.cuts: List[Tuple[str, int]] = []
        for i in range(cfg.num_hidden_layers):
            self.cuts += [("kda" if cfg.is_kda(i) else "attn", i)]
            self.cuts += [("moe", i)] if cfg.is_moe(i) else []
        self.decode_graphs = DecodeGraphs()

    @property
    def decode_segments(self) -> int:
        return len(self.cuts) + 1

    def decode_tensors(self):
        """The tensors the segments read: the layers' and the final norm's."""
        return (*self.model.layers.parameters(), *self.model.layers.buffers(),
                *self.model.norm.parameters())


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_kimi(cfg: KimiLinearConfig, seed: int = 0) -> KimiLinear:
    """Seeded fp32 weights on the CPU: matrices, convolution taps and the
    selection bias N(0, 0.02), norm scales 1, the gate's bias 0; ``A_log``
    = ln U(1, 16) and ``dt_bias`` = softplus⁻¹ of a log-uniform step in
    [0.001, 0.1], flash-linear-attention's initialisation."""
    model = KimiLinear(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if "norm" in name:
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            elif leaf == "A_log":
                p.copy_(torch.empty_like(p).uniform_(1, 16, generator=g).log())
            elif leaf == "dt_bias":
                p.copy_(inverse_softplus_dt(torch.empty_like(p).uniform_(0, 1, generator=g)))
            else:
                p.normal_(0.0, 0.02, generator=g)
    return model


def inverse_softplus_dt(u: Tensor) -> Tensor:
    """``dt_bias`` from uniform draws ``u`` in [0, 1): softplus⁻¹ of
    ``exp(ln 0.001 + u·(ln 0.1 − ln 0.001))``."""
    dt = (math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))).exp()
    return dt + torch.log(-torch.expm1(-dt))


def is_kimi(name_or_path: str) -> bool:
    """Whether a language-model name or directory is of this family."""
    if name_or_path in KIMI_PRESETS:
        return True
    cfg = os.path.join(name_or_path, "config.json")
    if os.path.isdir(name_or_path) and os.path.exists(cfg):
        with open(cfg) as f:
            return json.load(f).get("model_type") == "kimi_linear"
    return False


def load_kimi(name_or_path: str) -> KimiLinear:
    """A preset name → seeded weights (:func:`init_kimi`, seed 0), with a
    warning for the published model.  A checkpoint directory raises: its
    loader waits for the checkpoint's files."""
    if name_or_path not in KIMI_PRESETS:
        _unsupported(f"weights from '{name_or_path}' (a checkpoint loader)")
    if name_or_path != "kimi-linear-test":
        warnings.warn(
            f"No pretrained weights for '{name_or_path}' on disk. Using RANDOM "
            "initialization — fine for benchmarks, wrong for pretrained captioning.")
    return init_kimi(KIMI_PRESETS[name_or_path], seed=0)


# ---------------------------------------------------------------------------
# The hybrid cache
# ---------------------------------------------------------------------------


def init_kimi_cache(cfg: KimiLinearConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                    beam_size: Optional[int] = None, prefix_slots: int = 0,
                    device="cpu") -> HybridCache:
    """``decoding.init_hybrid_cache`` for ``batch`` rows: a latent cache
    ``[rows, slots, C + r]`` per MLA layer (plain, or ``beam_size`` beams
    with the folded prefix in slots ``[0, prefix_slots)``); per KDA layer
    two float32 state buffers [B, H, d, d] and two windows [B, 3, 3, H·d]
    (q, k, v's last three inputs)."""
    la = cfg.linear_attn_config
    H, d = la.num_heads, la.head_dim
    kda = [i for i in range(cfg.num_hidden_layers) if cfg.is_kda(i)]
    return init_hybrid_cache(cfg.num_hidden_layers, kda, cfg.latent_dim, (H, d, d),
                             torch.float32, (3, CONV_TAPS - 1, H * d), batch, max_len, dtype,
                             beam_size, prefix_slots, device)


def kimi_beam_cache(cfg: KimiLinearConfig, bp, groups: int, prefix_len: int, tile_major: bool,
                    dtype, device) -> Tuple[HybridCache, None]:
    """``gpt2.gpt2_beam_cache``'s contract with the folded-prefix hybrid
    cache alone: the other forms raise before anything is allocated."""
    what = folded_cache_only(bp, tile_major)
    if what:
        _unsupported(f"{what} in beam search")
    return init_kimi_cache(cfg, groups * bp.beam_size, bp.max_new_tokens, dtype, bp.beam_size,
                           prefix_len, device), None


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _kda_inputs(attn: _KDA, h: Tensor, cfg: KimiLinearConfig) -> tuple:
    """``h`` [..., D] (normalised) → the kernel's inputs and the output
    gate: q, k, v projections [..., H·d] (before their convolutions), the
    log decay g [..., H, d] and β [..., H] in float32, the gate [..., H·d]."""
    la = cfg.linear_attn_config
    f = attn.f_b_proj(attn.f_a_proj(h)).float().unflatten(-1, (la.num_heads, la.head_dim))
    dt_bias = attn.dt_bias.float().view(la.num_heads, la.head_dim)
    g = -attn.A_log.float().exp()[:, None] * F.softplus(f + dt_bias)
    beta = attn.b_proj(h).float().sigmoid()
    return (attn.q_proj(h), attn.k_proj(h), attn.v_proj(h), g, beta,
            attn.g_b_proj(attn.g_a_proj(h)))


def _kda_out(attn: _KDA, o: Tensor, gate: Tensor, cfg: KimiLinearConfig) -> Tensor:
    """``o`` [..., H, d] → ``RMSNorm_d(o) ⊙ w ⊙ sigmoid(gate)`` in float32,
    cast back, then ``o_proj`` → [..., D]."""
    of = o.float()
    y = of * torch.rsqrt(of.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps)
    y = y * attn.o_norm.weight.float() * gate.float().unflatten(-1, o.shape[-2:]).sigmoid()
    return attn.o_proj(y.to(o.dtype).flatten(-2))


def _kda_taps(attn: _KDA) -> tuple:
    return attn.q_conv1d.weight, attn.k_conv1d.weight, attn.v_conv1d.weight


def _kda_sequence(attn: _KDA, h: Tensor, cfg: KimiLinearConfig, cache: HybridCache, i: int,
                  offset: int) -> Tensor:
    """Positions ``[offset, offset + S)`` of ``h`` [B, S, D] through a KDA
    layer, each row continuing its own state (from zero at position 0),
    the kernel stepped token by token → [B, S, D]."""
    B, S, _ = h.shape
    q, k, v, g, beta, gate = _kda_inputs(attn, h, cfg)
    states, windows = cache.state[i], cache.conv[i]
    own = torch.arange(B, device=h.device, dtype=torch.int32)
    outs = []
    with annotate("kda.prefill"):
        for t in range(S):
            pos = offset + t
            a, b = pos % 2, (pos + 1) % 2
            outs.append(kda_decode(q[:, t], k[:, t], v[:, t], *_kda_taps(attn), g[:, t],
                                   beta[:, t], own if pos else torch.full_like(own, -1),
                                   windows[a], windows[b], states[a], states[b]))
    return _kda_out(attn, torch.stack(outs, 1), gate, cfg)


# -- beam decode steps: deepseek_v2's segments with this family's prologue --
#
# A KDA layer's prologue carries ``(x, None, q, k, v, g, beta, gate)``; its
# eager work is ``kda_decode`` over the row's parent; the next segment
# starts with the gated norm, ``o_proj`` and the residual.  MLA and expert
# layers carry what DeepSeek-V2's do (rope None).


def _prologue(model: KimiLinear, i: int, x: Tensor, rope, K: int) -> tuple:
    layer = model.model.layers[i]
    if not model.config.is_kda(i):
        return dsv2._prologue(model, i, x, None, K)
    return (x, None, *_kda_inputs(layer.self_attn, layer.input_layernorm(x)[:, 0],
                                  model.config))


def _mixer_out(layer: _Layer, kind: str, out: Tensor, carry: tuple, cfg, K: int) -> Tensor:
    if kind == "attn":
        return dsv2._mla_out(layer, kind, out, carry, cfg, K)
    return _kda_out(layer.self_attn, out, carry[7], cfg)[:, None]


def _eager_kda(attn: _KDA, carry: tuple, cache: HybridCache, i: int, parent: Tensor,
               pos: int, K: int) -> Tensor:
    """A KDA layer's eager work at position ``pos``: the kernel over each
    row's parent (this module's ``kda_decode``)."""
    states, windows = cache.state[i], cache.conv[i]
    a, b = pos % 2, (pos + 1) % 2
    with annotate("kda.decode"):
        return kda_decode(*carry[2:5], *_kda_taps(attn), carry[5], carry[6], parent,
                          windows[a], windows[b], states[a], states[b], K)


def _beam_decode_layers(model: KimiLinear, x: Tensor, cache: HybridCache, mask: Tensor,
                        slot: int, K: int, parent: Tensor, pos: int, steps) -> Tensor:
    """The layers and final norm of one beam decode step → [B, 1, D]."""
    cfg = model.config

    def segment(j, carry, *inputs):
        return dsv2._decode_segment(model, j, carry, inputs, K, prologue=_prologue,
                                    mixer_out=_mixer_out)

    carry = steps.run(segment, 0, x)
    for j, (kind, i) in enumerate(model.cuts):
        layer = model.model.layers[i]
        if kind == "kda":
            out = _eager_kda(layer.self_attn, carry, cache, i, parent, pos, K)
        elif kind == "attn":
            out = dsv2._eager_attn(cache.attn[i], carry, mask, slot, K, cfg)
        else:
            out = dsv2._eager_experts(layer, carry)
        carry = steps.run(segment, j + 1, out)
    return carry[0]


def kimi_apply(model: KimiLinear, *, input_ids: Optional[Tensor] = None,
               inputs_embeds: Optional[Tensor] = None, kv_cache: Optional[HybridCache] = None,
               cache_index: int = 0, dtype=torch.float32, return_logits: bool = True,
               beam_size: Optional[int] = None, ancestry: Optional[Tensor] = None,
               cache_base: int = 0, shared_kv=None, shared_len=None, graphs=None):
    """Kimi-Linear forward → ``(logits_or_hidden, kv_cache)``, with
    ``gpt2.gpt2_apply``'s arguments.

    ``kv_cache=None``: the whole input from position 0 (causal attention;
    each KDA layer's recurrence from a zero state, in scratch buffers).
    Cached, without ``ancestry``: the input at positions ``[cache_index,
    cache_index + S)``, each row continuing its own state (the prefill,
    and plain decoding).  Beam decode (``beam_size`` K, ``ancestry`` [B,
    Tl], ``cache_base`` P, one token): each row continues its parent's
    state, MLA reads the folded beam cache through the ancestry mask, and
    the segments run as ``gpt2_apply``'s.  The consolidated shared prefix
    and the replicated beam prefill raise ``NotImplementedError``."""
    cfg = model.config
    if shared_kv is not None or shared_len is not None:
        _unsupported("a consolidated shared-prefix cache")
    if inputs_embeds is None:
        inputs_embeds = embed(model.model.embed_tokens.weight, input_ids, dtype)
    x = inputs_embeds.to(dtype)
    B, S, _ = x.shape
    offset = cache_index if kv_cache is not None else 0
    if S > 1 and offset != 0:
        raise ValueError("cached prefill (S > 1) requires cache_index == 0")

    if kv_cache is not None and ancestry is not None:
        with beam_step("kimi.blocks", x, ancestry, beam_size, kv_cache.slots, offset,
                       cache_base, graphs) as (mask, slot, steps):
            parent = beam_parent(ancestry, beam_size, offset, cache_base)
            x = _beam_decode_layers(model, x, kv_cache, mask, slot, beam_size, parent, offset,
                                    steps)
        return (kimi_logits(model, x) if return_logits else x), kv_cache
    if graphs is not None:
        raise ValueError("graphs serve beam decode steps only (ancestry and one token)")
    if beam_size is not None:
        _unsupported("a replicated beam prefix (fold_prefix=False)")

    cache = kv_cache if kv_cache is not None else init_kimi_cache(cfg, B, S, x.dtype,
                                                                  device=x.device)
    bias = causal_bias(S, offset + S, offset, device=x.device)
    with annotate("kimi.blocks"):
        for i, layer in enumerate(model.model.layers):
            h = layer.input_layernorm(x)
            if cfg.is_kda(i):
                x = x + _kda_sequence(layer.self_attn, h, cfg, cache, i, offset)
            else:
                latent = cache.attn[i] if kv_cache is not None else None
                x = x + dsv2._attend(layer.self_attn, h, cfg, None, bias, latent, offset)
            h = layer.post_attention_layernorm(x)
            x = x + (dsv2._moe(layer.mlp, h, cfg) if cfg.is_moe(i) else layer.mlp(h))
    x = model.model.norm(x)
    return (kimi_logits(model, x) if return_logits else x), kv_cache


def kimi_embed_tokens(model: KimiLinear, token_ids: Tensor, dtype=torch.float32) -> Tensor:
    return embed(model.model.embed_tokens.weight, token_ids, dtype)


def kimi_logits(model: KimiLinear, hidden: Tensor) -> Tensor:
    """Project hidden states onto the vocabulary (the untied ``lm_head``)."""
    with annotate("kimi.lm_head"):
        return hidden @ model.lm_head.weight.to(hidden.dtype).t()
