"""Granite-4.0-H decoder family (Granite-4.0-H-Small) as ClipCap's language
model.

The equations follow the published modelling code of ``granitemoehybrid``
(``transformers``' ``modeling_granitemoehybrid.py``).  :class:`GraniteHybrid`
holds the weights under the published keys, except the mixture of
experts, which takes DeepSeek-V2's layout for the grouped kernel:
``mlp.gate.weight`` (the router), ``mlp.experts.gate_up_proj`` [E_held,
2F, D] (gate | up) and ``.down_proj`` [E_held, D, F] (the held share of the
published ``block_sparse_moe.input_linear`` / ``output_linear``), and
``mlp.shared_experts`` (the published ``shared_mlp``); :func:`load_granite`
maps a published checkpoint onto them.

* A pre-norm residual block, each branch scaled by ``residual_multiplier``
  before the add: ``input_layernorm`` → Mamba-2 or attention; then
  ``post_attention_layernorm`` → the routed experts + the shared MLP.  The
  input embeddings (the mapper's prefix too, as ``transformers`` applies it
  to any ``inputs_embeds``) × ``embedding_multiplier``; the final ``norm``
  and the head tied to ``embed_tokens``, the logits ÷ ``logits_scaling``.
  The mixers follow ``layer_types``.
* Mamba-2 (one group): ``in_proj`` → z | xBC | dt; the causal depthwise
  convolution of kernel 4 with its bias over xBC, SiLU → x | B | C; per
  head, ``dt = softplus(dt + dt_bias)`` (no clamp), ``A = −exp(A_log)``,
  the state h ∈ ℝ^{P×N} from zero: ``h ← exp(dt·A)·h + dt·x ⊗ B``, ``y =
  h·C + D·x``; the gated norm ``w ⊙ RMSNorm(y ⊙ SiLU(z))`` over all heads
  (the gate first, then the norm); ``out_proj``.  The step is
  ``ops/mamba.py::mamba_decode`` (the CUDA kernel on the card, its twin on
  the CPU), which also moves the convolution's window.
* Grouped-query attention without rotation (``position_embedding_type``
  ``nope``): H query heads over Hkv K|V heads, softmax scale
  ``attention_multiplier``.
* The mixture of experts as DeepSeek-V2's layer (``deepseek_v2._dispatch``,
  ``_combine``, ``grouped_expert_mlp``) with :class:`Routing`: float32
  router logits, softmax, the top ``num_experts_per_tok``, renormalised
  over the chosen (the published softmax over the top-k logits); the
  shared MLP (SwiGLU, the gate in the first half of ``input_linear``) on
  every row.  The layer holds the experts ``experts_held`` (expert
  parallelism: one chip's share); it routes over all ``num_local_experts``
  and adds the held experts' part.

The beam cache (``decoding.HybridCache``) holds a K|V cache per attention
layer in the beam layout of ``models/decoding.py`` (slots never move) and,
per Mamba layer, two state buffers ``[B, H, P, N]`` in the cache's dtype
(bf16 on the card) and two windows of the last three xBC inputs ``[B, 3,
H·P + 2N]``: the step at position t reads buffer t % 2 of each row's parent
(``decoding.beam_parent``) and writes buffer (t + 1) % 2 of the row.  The
prefill over the prefix runs once per sample, into rows ``[0, R)``,
stepping the same kernel token by token.

A beam decode step runs as dense segments split at each layer's Mamba
step or attention and at each layer's grouped experts
(``deepseek_v2._decode_segment`` with this family's prologue and residual
multiplier); the Mamba kernel, the K|V write with ``gqa_decode`` and the
grouped experts run eagerly between them, the last through
``models.deepseek_v2``'s attribute.  On the card the segments replay CUDA
graphs; the parent index and the routing stay on the device.
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

from clipcap_tpu_torch.models import deepseek_v2 as dsv2
from clipcap_tpu_torch.models.decoding import (DecodeGraphs, HybridCache, beam_parent, beam_step,
                                              causal_bias, folded_cache_only, init_hybrid_cache,
                                              softmax_attend)
from clipcap_tpu_torch.models.deepseek_v2 import RMSNorm, Routing
from clipcap_tpu_torch.models.kimi_linear import inverse_softplus_dt
from clipcap_tpu_torch.ops.gqa import gqa_decode
from clipcap_tpu_torch.ops.layers import Linear, embed, empty_param
from clipcap_tpu_torch.ops.mamba import CONV_TAPS, mamba_decode
from clipcap_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

# The published mixers: attention at layers 5, 15, 25 and 35 (0-based).
LAYER_TYPES = tuple("attention" if i in (5, 15, 25, 35) else "mamba" for i in range(40))


@dataclasses.dataclass(frozen=True)
class GraniteHybridConfig:
    """The published ``config.json`` keys the model reads, plus the experts
    this chip holds (``experts_held``, expert parallelism) and the eos id."""
    vocab_size: int = 100352
    hidden_size: int = 4096
    intermediate_size: int = 768
    shared_intermediate_size: int = 1536
    num_hidden_layers: int = 40
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    layer_types: Tuple[str, ...] = LAYER_TYPES
    mamba_n_heads: int = 128
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    num_local_experts: int = 72
    num_experts_per_tok: int = 10
    attention_multiplier: float = 0.0078125
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 16.0
    rms_norm_eps: float = 1e-5
    experts_held: Tuple[int, int] = (0, 72)
    eos_token_id: int = 100257
    name: str = "ibm-granite/granite-4.0-h-small"

    @property
    def n_embd(self) -> int:
        """The hidden width under GPT-2's name (the mapper's LM width)."""
        return self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def mamba_inner(self) -> int:
        return self.mamba_expand * self.hidden_size

    @property
    def conv_dim(self) -> int:
        """xBC's channels: x, then B and C of each group."""
        return self.mamba_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def routing(self) -> Routing:
        return Routing(self.num_local_experts, self.num_experts_per_tok, "softmax", True, 1.0,
                       tuple(self.experts_held))

    def is_moe(self, layer: int) -> bool:
        return True

    def is_mamba(self, layer: int) -> bool:
        return self.layer_types[layer] == "mamba"


GRANITE_PRESETS: Dict[str, GraniteHybridConfig] = {
    # The catalog's row of huggingface.co/ibm-granite/granite-4.0-h-small
    # config.json, holding experts 0-8 of 72: one chip's share under expert
    # parallelism 8.  The eos id is assumed (the catalog strips it).
    "ibm-granite/granite-4.0-h-small": GraniteHybridConfig(experts_held=(0, 9)),
    # Test-scale preset (not a published model): every mechanism, tiny widths.
    "granite-hybrid-test": GraniteHybridConfig(
        vocab_size=512, hidden_size=64, intermediate_size=32, shared_intermediate_size=48,
        num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
        layer_types=("mamba", "attention", "mamba", "mamba"), mamba_n_heads=8, mamba_d_head=16,
        mamba_d_state=16, num_local_experts=8, num_experts_per_tok=3, experts_held=(0, 8),
        eos_token_id=1, name="granite-hybrid-test"),
}


def _unsupported(what: str):
    raise NotImplementedError(f"Granite-4.0-H with {what} is not ported "
                              f"(ROADMAP.md, {GraniteHybrid.roadmap_item})")


def granite_config_from_hf(hf: Mapping, experts_held: Optional[Tuple[int, int]] = None,
                           name: Optional[str] = None) -> GraniteHybridConfig:
    """A config from a ``config.json`` dict of ``model_type``
    ``granitemoehybrid`` (the held experts default to all); a setting the
    port does not run raises."""
    types = hf.get("layer_types") or ["mamba"] * hf["num_hidden_layers"]
    checks = [(hf.get("position_embedding_type") == "rope", "rotary attention"),
              (bool(hf.get("attention_bias", False)), "attention biases"),
              (bool(hf.get("mamba_proj_bias", False)), "Mamba projection biases"),
              (not hf.get("mamba_conv_bias", True), "a convolution without a bias"),
              (hf.get("mamba_n_groups", 1) != 1, "more than one Mamba group"),
              (hf.get("mamba_d_conv", CONV_TAPS) != CONV_TAPS,
               f"a convolution of kernel {hf.get('mamba_d_conv')}"),
              (hf.get("hidden_act", "silu") != "silu", "an activation other than silu"),
              (not hf.get("tie_word_embeddings", True), "an untied LM head"),
              (not hf.get("num_local_experts"), "no routed experts"),
              ("attention" not in types, "no attention layer")]
    for bad, what in checks:
        if bad:
            _unsupported(what)
    keys = [f.name for f in dataclasses.fields(GraniteHybridConfig)
            if f.name not in ("layer_types", "experts_held", "eos_token_id", "name")]
    eos = hf.get("eos_token_id", GraniteHybridConfig.eos_token_id)
    return GraniteHybridConfig(**{k: hf[k] for k in keys if k in hf}, layer_types=tuple(types),
                               experts_held=tuple(experts_held or (0, hf["num_local_experts"])),
                               eos_token_id=eos if isinstance(eos, int) else eos[0],
                               name=name or hf.get("_name_or_path") or "granite-hybrid-custom")


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------


class _Mamba(nn.Module):
    """A Mamba-2 mixer's weights under the published names: ``conv1d``'s
    ``weight`` [C, 1, 4] and ``bias`` [C] as ``nn.Conv1d``'s; ``norm`` the
    gated norm's scale."""

    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        D, I, C, H = cfg.hidden_size, cfg.mamba_inner, cfg.conv_dim, cfg.mamba_n_heads
        self.in_proj = Linear(D, I + C + H, bias=False)
        self.conv1d = nn.Module()
        self.conv1d.weight = empty_param(C, 1, cfg.mamba_d_conv)
        self.conv1d.bias = empty_param(C)
        self.dt_bias = empty_param(H)
        self.A_log = empty_param(H)
        self.D = empty_param(H)
        self.norm = RMSNorm(I, cfg.rms_norm_eps)
        self.out_proj = Linear(I, D, bias=False)


class _GQA(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        D, Dh = cfg.hidden_size, cfg.head_dim
        self.q_proj = Linear(D, cfg.num_attention_heads * Dh, bias=False)
        self.k_proj = Linear(D, cfg.num_key_value_heads * Dh, bias=False)
        self.v_proj = Linear(D, cfg.num_key_value_heads * Dh, bias=False)
        self.o_proj = Linear(cfg.num_attention_heads * Dh, D, bias=False)


class _SharedMLP(nn.Module):
    """The published ``shared_mlp``: SwiGLU, gate | up in ``input_linear``."""

    def __init__(self, d: int, f: int):
        super().__init__()
        self.input_linear = Linear(d, 2 * f, bias=False)
        self.output_linear = Linear(f, d, bias=False)

    def forward(self, x: Tensor) -> Tensor:
        gate, up = self.input_linear(x).chunk(2, dim=-1)
        return self.output_linear(F.silu(gate) * up)


class _MoE(nn.Module):
    """DeepSeek-V2's expert layer layout: the router over all
    ``num_local_experts``, the held experts stacked (local index e is expert
    ``held[0] + e``), the shared MLP."""

    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        r = cfg.routing
        D, Fw = cfg.hidden_size, cfg.intermediate_size
        self.gate = nn.Module()
        self.gate.weight = empty_param(r.n_experts, D)
        self.experts = nn.Module()
        self.experts.gate_up_proj = empty_param(r.n_held, 2 * Fw, D)
        self.experts.down_proj = empty_param(r.n_held, D, Fw)
        self.shared_experts = _SharedMLP(D, cfg.shared_intermediate_size)


class _Layer(nn.Module):
    def __init__(self, cfg: GraniteHybridConfig, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        if cfg.is_mamba(i):
            self.mamba = _Mamba(cfg)
        else:
            self.self_attn = _GQA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.mlp = _MoE(cfg)


class GraniteHybrid(nn.Module):
    """Granite-4.0-H weights (experts stacked, the held share only; the head
    tied to ``model.embed_tokens``).  Built empty: weights come from
    :func:`init_granite`, :func:`granite_from_hf` or
    ``load_state_dict(assign=True)``."""

    roadmap_item = "F14"       # what the port does not run with it yet

    def __init__(self, cfg: GraniteHybridConfig):
        super().__init__()
        self.config = cfg
        self.model = nn.Module()
        self.model.embed_tokens = nn.Module()
        self.model.embed_tokens.weight = empty_param(cfg.vocab_size, cfg.hidden_size)
        self.model.layers = nn.ModuleList(_Layer(cfg, i) for i in range(cfg.num_hidden_layers))
        self.model.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        # A beam decode step's eager work, in order: each layer's Mamba step
        # or attention, then its grouped experts.
        self.cuts: List[Tuple[str, int]] = []
        for i in range(cfg.num_hidden_layers):
            self.cuts += [("mamba" if cfg.is_mamba(i) else "attn", i), ("moe", i)]
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


def init_granite(cfg: GraniteHybridConfig, seed: int = 0) -> GraniteHybrid:
    """Seeded fp32 weights on the CPU: matrices N(0, 0.02), norm scales and
    ``D`` 1; Mamba-2's initialisation elsewhere: the convolution's taps and
    bias U(−1/2, 1/2) (``nn.Conv1d``'s, 1/√4), ``A_log`` = ln U(1, 16),
    ``dt_bias`` = softplus⁻¹ of a log-uniform step in [0.001, 0.1]."""
    model = GraniteHybrid(cfg)
    g = torch.Generator().manual_seed(seed)
    bound = 1 / math.sqrt(cfg.mamba_d_conv)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if "norm" in name or leaf == "D":
                p.fill_(1.0)
            elif ".conv1d." in name:
                p.uniform_(-bound, bound, generator=g)
            elif leaf == "A_log":
                p.copy_(torch.empty_like(p).uniform_(1, 16, generator=g).log())
            elif leaf == "dt_bias":
                p.copy_(inverse_softplus_dt(torch.empty_like(p).uniform_(0, 1, generator=g)))
            else:
                p.normal_(0.0, 0.02, generator=g)
    return model


def granite_from_hf(state_dict: Mapping[str, Tensor], cfg: GraniteHybridConfig) -> GraniteHybrid:
    """A model from a published ``GraniteMoeHybridForCausalLM`` state dict:
    each layer's router, the held share ``[held[0], held[1])`` of its
    stacked ``input_linear`` / ``output_linear`` and its shared MLP under
    the port's keys; the tied ``lm_head.weight``, if present, dropped."""
    lo, hi = cfg.experts_held
    sd = {}
    for k, v in state_dict.items():
        if k == "lm_head.weight":
            continue
        k = k.replace(".block_sparse_moe.router.layer.", ".mlp.gate.")
        k = k.replace(".shared_mlp.", ".mlp.shared_experts.")
        if ".block_sparse_moe." in k:
            k = k.replace(".block_sparse_moe.input_linear.weight", ".mlp.experts.gate_up_proj")
            k = k.replace(".block_sparse_moe.output_linear.weight", ".mlp.experts.down_proj")
            v = v[lo:hi]
        sd[k] = v.detach()
    with torch.device("meta"):
        model = GraniteHybrid(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def is_granite(name_or_path: str) -> bool:
    """Whether a language-model name or directory is of this family."""
    if name_or_path in GRANITE_PRESETS:
        return True
    cfg = os.path.join(name_or_path, "config.json")
    if os.path.isdir(name_or_path) and os.path.exists(cfg):
        with open(cfg) as f:
            return json.load(f).get("model_type") == "granitemoehybrid"
    return False


def load_granite(name_or_path: str,
                 experts_held: Optional[Tuple[int, int]] = None) -> GraniteHybrid:
    """Resolve a Granite-4.0-H without the network: a local directory with
    the published ``config.json`` and ``*.safetensors`` weights (holding
    ``experts_held``, default all); else, for a preset name, seeded weights
    (:func:`init_granite`, seed 0), with a warning for the published model."""
    from clipcap_tpu_torch.models.hf_import import load_torch_state_dict

    if os.path.isdir(name_or_path):
        with open(os.path.join(name_or_path, "config.json")) as f:
            cfg = granite_config_from_hf(json.load(f), experts_held, name=name_or_path)
        files = sorted(glob.glob(os.path.join(name_or_path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no weights file in {name_or_path}")
        sd = {}
        for path in files:
            sd.update(load_torch_state_dict(path))
        return granite_from_hf(sd, cfg)
    if name_or_path not in GRANITE_PRESETS:
        raise ValueError(f"cannot resolve language model '{name_or_path}'")
    if name_or_path != "granite-hybrid-test":
        warnings.warn(
            f"No pretrained weights for '{name_or_path}' on disk. Using RANDOM "
            "initialization — fine for benchmarks, wrong for pretrained captioning.")
    return init_granite(GRANITE_PRESETS[name_or_path], seed=0)


# ---------------------------------------------------------------------------
# The hybrid cache
# ---------------------------------------------------------------------------


def init_granite_cache(cfg: GraniteHybridConfig, batch: int, max_len: int,
                       dtype=torch.bfloat16, beam_size: Optional[int] = None,
                       prefix_slots: int = 0, device="cpu") -> HybridCache:
    """``decoding.init_hybrid_cache`` for ``batch`` rows: a K|V cache
    ``[rows, slots, 2·Hkv·Dh]`` per attention layer (plain, or ``beam_size``
    beams with the folded prefix in slots ``[0, prefix_slots)``); per Mamba
    layer two state buffers [B, H, P, N] and two windows [B, 3, C] in
    ``dtype``."""
    mamba = [i for i in range(cfg.num_hidden_layers) if cfg.is_mamba(i)]
    return init_hybrid_cache(
        cfg.num_hidden_layers, mamba, 2 * cfg.num_key_value_heads * cfg.head_dim,
        (cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state), dtype,
        (CONV_TAPS - 1, cfg.conv_dim), batch, max_len, dtype, beam_size, prefix_slots, device)


def granite_beam_cache(cfg: GraniteHybridConfig, bp, groups: int, prefix_len: int,
                       tile_major: bool, dtype, device) -> Tuple[HybridCache, None]:
    """``gpt2.gpt2_beam_cache``'s contract with the folded-prefix hybrid
    cache alone: the other forms raise before anything is allocated."""
    what = folded_cache_only(bp, tile_major)
    if what:
        _unsupported(f"{what} in beam search")
    return init_granite_cache(cfg, groups * bp.beam_size, bp.max_new_tokens, dtype,
                              bp.beam_size, prefix_len, device), None


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _mamba_inputs(m: _Mamba, h: Tensor, cfg: GraniteHybridConfig) -> tuple:
    """``h`` [..., D] (normalised) → ``in_proj``'s z [..., I], xBC [..., C]
    and dt [..., H] (views of one product)."""
    zxbcdt = m.in_proj(h)
    return zxbcdt.split([cfg.mamba_inner, cfg.conv_dim, cfg.mamba_n_heads], dim=-1)


def _mamba_params(m: _Mamba, dtype) -> tuple:
    """The kernel's weights in the step's dtype: taps, bias, A_log, D, dt_bias."""
    return tuple(t.to(dtype) for t in (m.conv1d.weight, m.conv1d.bias, m.A_log, m.D, m.dt_bias))


def _mamba_out(m: _Mamba, y: Tensor, z: Tensor, cfg: GraniteHybridConfig) -> Tensor:
    """``y`` [..., I] → the gated norm ``w ⊙ RMSNorm(y ⊙ SiLU(z))`` (float32
    inside, cast back before the scale), then ``out_proj`` → [..., D]."""
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt(g.pow(2).mean(-1, keepdim=True) + cfg.rms_norm_eps)
    return m.out_proj(m.norm.weight.to(y.dtype) * g.to(y.dtype))


def _mamba_sequence(m: _Mamba, h: Tensor, cfg: GraniteHybridConfig, cache: HybridCache, i: int,
                    offset: int) -> Tensor:
    """Positions ``[offset, offset + S)`` of ``h`` [B, S, D] through a Mamba
    layer, each row continuing its own state (from zero at position 0),
    the kernel stepped token by token → [B, S, D]."""
    B, S, _ = h.shape
    z, xbc, dt = _mamba_inputs(m, h, cfg)
    states, windows = cache.state[i], cache.conv[i]
    own = torch.arange(B, device=h.device, dtype=torch.int32)
    params = _mamba_params(m, xbc.dtype)
    outs = []
    with annotate("mamba.prefill"):
        for t in range(S):
            pos = offset + t
            a, b = pos % 2, (pos + 1) % 2
            outs.append(mamba_decode(xbc[:, t], dt[:, t], *params,
                                     own if pos else torch.full_like(own, -1), windows[a],
                                     windows[b], states[a], states[b]))
    return _mamba_out(m, torch.stack(outs, 1), z, cfg)


def _attend(attn: _GQA, h: Tensor, cfg: GraniteHybridConfig, bias: Tensor,
            cache: Optional[Tensor], offset: int) -> Tensor:
    """Causal grouped-query attention of positions ``[offset, offset + S)``:
    over the input alone (no cache), or over the cache's slots ``[0, offset
    + S)`` after writing the input's K | V there.  → ``o_proj``'s output."""
    B, S, _ = h.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    q = attn.q_proj(h).view(B, S, H, Dh).transpose(1, 2)
    kv = torch.cat([attn.k_proj(h), attn.v_proj(h)], dim=-1)
    if cache is not None:
        cache[:, offset:offset + S] = kv
        kv = cache[:, :offset + S]
    k, v = (t.transpose(1, 2).repeat_interleave(H // Hkv, dim=1)
            for t in kv.unflatten(-1, (2, Hkv, Dh)).unbind(2))
    o = softmax_attend(q, k, v, bias, cfg.attention_multiplier)
    return attn.o_proj(o.transpose(1, 2).reshape(B, S, H * Dh))


# -- beam decode steps: deepseek_v2's segments with this family's prologue --
#
# A Mamba layer's prologue carries ``(x, None, z, xBC, dt)``; its eager work
# is ``mamba_decode`` over the row's parent; the next segment starts with
# the gated norm, ``out_proj`` and the scaled residual.  An attention
# layer's carries ``(x, None, q, row)`` (q [R, K, H, Dh], the K rows' K | V);
# its eager work writes the rows and runs ``gqa_decode``.  Expert layers
# carry what DeepSeek-V2's do.  Segment 0 scales the input embeddings.


def _prologue(model: GraniteHybrid, i: int, x: Tensor, rope, K: int) -> tuple:
    cfg = model.config
    layer = model.model.layers[i]
    h = layer.input_layernorm(x)[:, 0]
    if cfg.is_mamba(i):
        return (x, None, *_mamba_inputs(layer.mamba, h, cfg))
    attn = layer.self_attn
    B = h.shape[0]
    q = attn.q_proj(h).view(B // K, K, cfg.num_attention_heads, cfg.head_dim)
    return x, None, q, torch.cat([attn.k_proj(h), attn.v_proj(h)], dim=-1).view(B // K, K, -1)


def _mixer_out(layer: _Layer, kind: str, out: Tensor, carry: tuple, cfg, K: int) -> Tensor:
    if kind == "mamba":
        return _mamba_out(layer.mamba, out, carry[2], cfg)[:, None]
    R = out.shape[0]
    return layer.self_attn.o_proj(out.reshape(R * K, 1, -1))


def _eager_mamba(m: _Mamba, carry: tuple, cache: HybridCache, i: int, parent: Tensor,
                 pos: int, K: int) -> Tensor:
    """A Mamba layer's eager work at position ``pos``: the kernel over each
    row's parent (this module's ``mamba_decode``)."""
    states, windows = cache.state[i], cache.conv[i]
    a, b = pos % 2, (pos + 1) % 2
    xbc, dt = carry[3], carry[4]
    with annotate("mamba.decode"):
        return mamba_decode(xbc, dt, *_mamba_params(m, xbc.dtype), parent, windows[a],
                            windows[b], states[a], states[b], K)


def _eager_gqa(cache: Tensor, carry: tuple, mask: Tensor, slot: int, K: int, cfg) -> Tensor:
    """An attention layer's eager work: the K rows' K | V into the cache at
    ``slot``, then :func:`gqa_decode` (this module's attribute)."""
    cache[:, slot:slot + K] = carry[3]
    with annotate("gqa.decode"):
        return gqa_decode(carry[2], cache, mask, slot + K, cfg.attention_multiplier,
                          cfg.num_key_value_heads)


def _beam_decode_layers(model: GraniteHybrid, x: Tensor, cache: HybridCache, mask: Tensor,
                        slot: int, K: int, parent: Tensor, pos: int, steps) -> Tensor:
    """The layers and final norm of one beam decode step → [B, 1, D]."""
    cfg = model.config

    def segment(j, carry, *inputs):
        if j == 0:
            inputs = (inputs[0] * cfg.embedding_multiplier,)
        return dsv2._decode_segment(model, j, carry, inputs, K, prologue=_prologue,
                                    mixer_out=_mixer_out, residual=cfg.residual_multiplier)

    carry = steps.run(segment, 0, x)
    for j, (kind, i) in enumerate(model.cuts):
        layer = model.model.layers[i]
        if kind == "mamba":
            out = _eager_mamba(layer.mamba, carry, cache, i, parent, pos, K)
        elif kind == "attn":
            out = _eager_gqa(cache.attn[i], carry, mask, slot, K, cfg)
        else:
            out = dsv2._eager_experts(layer, carry)
        carry = steps.run(segment, j + 1, out)
    return carry[0]


def granite_apply(model: GraniteHybrid, *, input_ids: Optional[Tensor] = None,
                  inputs_embeds: Optional[Tensor] = None,
                  kv_cache: Optional[HybridCache] = None, cache_index: int = 0,
                  dtype=torch.float32, return_logits: bool = True,
                  beam_size: Optional[int] = None, ancestry: Optional[Tensor] = None,
                  cache_base: int = 0, shared_kv=None, shared_len=None, graphs=None):
    """Granite-4.0-H forward → ``(logits_or_hidden, kv_cache)``, with
    ``gpt2.gpt2_apply``'s arguments.

    ``kv_cache=None``: the whole input from position 0 (causal attention;
    each Mamba layer's recurrence from a zero state, in scratch buffers).
    Cached, without ``ancestry``: the input at positions ``[cache_index,
    cache_index + S)``, each row continuing its own state (the prefill, and
    plain decoding).  Beam decode (``beam_size`` K, ``ancestry`` [B, Tl],
    ``cache_base`` P, one token): each row continues its parent's state,
    attention reads the folded beam cache through the ancestry mask, and
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
        with beam_step("granite.blocks", x, ancestry, beam_size, kv_cache.slots, offset,
                       cache_base, graphs) as (mask, slot, steps):
            parent = beam_parent(ancestry, beam_size, offset, cache_base)
            x = _beam_decode_layers(model, x, kv_cache, mask, slot, beam_size, parent, offset,
                                    steps)
        return (granite_logits(model, x) if return_logits else x), kv_cache
    if graphs is not None:
        raise ValueError("graphs serve beam decode steps only (ancestry and one token)")
    if beam_size is not None:
        _unsupported("a replicated beam prefix (fold_prefix=False)")

    cache = kv_cache if kv_cache is not None else init_granite_cache(cfg, B, S, x.dtype,
                                                                     device=x.device)
    bias = causal_bias(S, offset + S, offset, device=x.device)
    m = cfg.residual_multiplier
    with annotate("granite.blocks"):
        x = x * cfg.embedding_multiplier
        for i, layer in enumerate(model.model.layers):
            h = layer.input_layernorm(x)
            if cfg.is_mamba(i):
                out = _mamba_sequence(layer.mamba, h, cfg, cache, i, offset)
            else:
                out = _attend(layer.self_attn, h, cfg, bias,
                              cache.attn[i] if kv_cache is not None else None, offset)
            x = x + out * m
            x = x + dsv2._moe(layer.mlp, layer.post_attention_layernorm(x), cfg) * m
    x = model.model.norm(x)
    return (granite_logits(model, x) if return_logits else x), kv_cache


def granite_embed_tokens(model: GraniteHybrid, token_ids: Tensor, dtype=torch.float32) -> Tensor:
    """The token embeddings as looked up (the forward applies the multiplier)."""
    return embed(model.model.embed_tokens.weight, token_ids, dtype)


def granite_logits(model: GraniteHybrid, hidden: Tensor) -> Tensor:
    """Project hidden states onto the vocabulary: the head tied to
    ``embed_tokens``, the logits ÷ ``logits_scaling``."""
    with annotate("granite.lm_head"):
        w = model.model.embed_tokens.weight.to(hidden.dtype)
        return torch.matmul(hidden, w.t()).div_(model.config.logits_scaling)
