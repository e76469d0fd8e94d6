"""LongCat-Flash decoder family (LongCat-Flash-Chat) as ClipCap's language
model.

The equations follow the published modelling code of ``longcat_flash``
(``transformers``' ``modeling_longcat_flash.py``; the LongCat-Flash
technical report, arXiv:2509.01322).  :class:`LongcatFlash` holds the
weights under the published keys, except the routed experts, which it
stacks as DeepSeek-V2's layer does for the grouped kernel:
``mlp.experts.gate_up_proj`` [E_held, 2F, D] (gate | up) and
``mlp.experts.down_proj`` [E_held, D, F], the held share of the published
per-expert ``mlp.experts.{e}.{gate,up,down}_proj``; :func:`load_longcat`
maps a published checkpoint onto them.

* ``num_layers`` double layers, each with two latent attentions, two dense
  SwiGLU MLPs (``ffn_hidden_size``) and one mixture of experts whose input
  is the first MLP's and whose output skips the rest of the layer (the
  shortcut-connected MoE, ScMoE)::

      x += attn0(ln_in0(x));  h = ln_post0(x);  s = MoE(h);  x += mlp0(h)
      x += attn1(ln_in1(x));  x = x + mlp1(ln_post1(x)) + s

  Then the final ``norm`` and the untied ``lm_head``.  RMSNorm is float32
  inside, its output cast back before the scale.
* Multi-head latent attention with a query LoRA (DeepSeek-V2's ``_MLA``
  with ``q_lora_rank``): ``q = q_b(RMSNorm(q_a(h)))·√(D / q_lora)``; the
  normalised latent × √(D / kv_lora) before ``kv_b_proj`` (so the keys and
  values carry the scale, and the cache holds the scaled latent); RoPE on
  the interleaved pairs at ``rope_theta``, no YaRN; softmax scale
  ``q_head_dim^-0.5``.
* The mixture of experts: float32 router logits over ``n_routed_experts``
  FFN experts + ``zero_expert_num`` identity experts, softmax, the top
  ``moe_topk`` by score + ``e_score_correction_bias``, weights the
  unbiased scores × ``routed_scaling_factor`` (not renormalised); an FFN
  expert is a SwiGLU of ``expert_ffn_hidden_size``, an identity expert
  returns ``h``.  The layer holds the FFN experts ``experts_held`` (expert
  parallelism: one chip's share); it routes over all of them and adds the
  held experts' part and the identity experts' (which every chip computes
  alike): DeepSeek-V2's ``_dispatch``, ``_combine`` and ``_experts`` with
  :class:`~clipcap_tpu_torch.models.deepseek_v2.Routing`'s zero experts.

The beam cache holds one latent cache ``[rows, slots, C + r]`` per latent
attention (2·``num_layers``), in the beam layout of ``models/decoding.py``.
A beam decode step runs as DeepSeek-V2's dense segments
(``deepseek_v2._decode_segment`` over the halves of the double layers,
with the shortcut), split at each latent attention and each expert layer:
the cache write with ``mla_decode`` and the grouped experts run eagerly
between them, through ``models.deepseek_v2``'s attributes.  The expert
layer's routed sum rides in the carries across the second attention and is
added at the end of the layer.  On the card the segments replay CUDA
graphs; the routing stays on the device.
"""
from __future__ import annotations

import dataclasses
import glob
import json
import os
import warnings
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from clipcap_tpu_torch.models import deepseek_v2 as dsv2
from clipcap_tpu_torch.models.decoding import (DecodeGraphs, beam_step, causal_bias,
                                              folded_cache_only)
from clipcap_tpu_torch.models.deepseek_v2 import (_MLA, _MLP, RMSNorm, Routing,
                                                  init_latent_cache, rope_cos_sin)
from clipcap_tpu_torch.ops.layers import embed, empty_param
from clipcap_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

# The seeded selection bias's scale: about one uniform score (1/768 at the
# published widths), so it moves picks near the top-k boundary (~7% of them
# there) without fixing a token's experts.
BIAS_STD = 1e-3


@dataclasses.dataclass(frozen=True)
class LongcatFlashConfig:
    """The published ``config.json`` keys the model reads, plus the FFN
    experts this chip holds (``experts_held``, expert parallelism) and the
    eos id."""
    vocab_size: int = 131072
    hidden_size: int = 6144
    ffn_hidden_size: int = 12288
    expert_ffn_hidden_size: int = 2048
    num_layers: int = 28
    num_attention_heads: int = 64
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    mla_scale_q_lora: bool = True
    mla_scale_kv_lora: bool = True
    n_routed_experts: int = 512
    zero_expert_num: int = 256
    moe_topk: int = 12
    routed_scaling_factor: float = 6.0
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000000.0
    max_position_embeddings: int = 131072
    experts_held: Tuple[int, int] = (0, 512)
    eos_token_id: int = 2
    name: str = "meituan-longcat/LongCat-Flash-Chat"

    rope_scaling = None                 # plain RoPE: no YaRN

    @property
    def n_embd(self) -> int:
        """The hidden width under GPT-2's name (the mapper's LM width)."""
        return self.hidden_size

    @property
    def num_hidden_layers(self) -> int:
        """Half layers: two a double layer (the published config's value)."""
        return 2 * self.num_layers

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a cache slot holds: the scaled latent and the roped ``k_pe``."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def mla_scales(self) -> Tuple[Optional[float], Optional[float]]:
        """The scales of q and of the normalised latent (None: unscaled)."""
        D = self.hidden_size
        return ((D / self.q_lora_rank) ** 0.5 if self.mla_scale_q_lora else None,
                (D / self.kv_lora_rank) ** 0.5 if self.mla_scale_kv_lora else None)

    @property
    def routing(self) -> Routing:
        return Routing(self.n_routed_experts, self.moe_topk, "softmax", False,
                       self.routed_scaling_factor, tuple(self.experts_held),
                       zero_experts=self.zero_expert_num, biased=True)

    def is_moe(self, half: int) -> bool:
        """Whether half layer ``half`` ends in the expert layer (the first
        half of each double layer: the MoE reads its MLP's input)."""
        return half % 2 == 0


LONGCAT_PRESETS: Dict[str, LongcatFlashConfig] = {
    # The catalog's row of huggingface.co/meituan-longcat/LongCat-Flash-Chat
    # config.json, holding FFN experts 0-7 of 512: one chip's share under
    # expert parallelism 64.  The eos id is the config class's default (the
    # catalog strips it).
    "meituan-longcat/LongCat-Flash-Chat": LongcatFlashConfig(experts_held=(0, 8)),
    # Test-scale preset (not a published model): every mechanism, tiny widths.
    "longcat-flash-test": LongcatFlashConfig(
        vocab_size=512, hidden_size=64, ffn_hidden_size=96, expert_ffn_hidden_size=32,
        num_layers=2, num_attention_heads=4, q_lora_rank=24, kv_lora_rank=16,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
        zero_expert_num=4, moe_topk=3, max_position_embeddings=512, experts_held=(0, 8),
        eos_token_id=1, name="longcat-flash-test"),
}


def _unsupported(what: str):
    raise NotImplementedError(f"LongCat-Flash with {what} is not ported "
                              f"(ROADMAP.md, {LongcatFlash.roadmap_item})")


def longcat_config_from_hf(hf: Mapping, experts_held: Optional[Tuple[int, int]] = None,
                           name: Optional[str] = None) -> LongcatFlashConfig:
    """A config from a ``config.json`` dict of ``model_type``
    ``longcat_flash`` (the held experts default to all); a setting the port
    does not run raises."""
    heads = hf["num_attention_heads"]
    checks = [(bool(hf.get("attention_bias", False)), "attention biases"),
              (bool(hf.get("router_bias", False)), "a router bias"),
              (hf.get("rope_scaling") is not None, "rope scaling"),
              (hf.get("hidden_act", "silu") != "silu", "an activation other than silu"),
              (bool(hf.get("tie_word_embeddings", False)), "a tied LM head"),
              (hf.get("zero_expert_type", "identity") != "identity",
               f"zero experts of type {hf.get('zero_expert_type')!r}"),
              (not hf.get("q_lora_rank"), "no query LoRA"),
              (hf.get("num_key_value_heads") not in (None, heads), "grouped key/value heads")]
    for bad, what in checks:
        if bad:
            _unsupported(what)
    keys = [f.name for f in dataclasses.fields(LongcatFlashConfig)
            if f.name not in ("experts_held", "eos_token_id", "name")]
    eos = hf.get("eos_token_id", LongcatFlashConfig.eos_token_id)
    return LongcatFlashConfig(**{k: hf[k] for k in keys if k in hf},
                              experts_held=tuple(experts_held or (0, hf["n_routed_experts"])),
                              eos_token_id=eos if isinstance(eos, int) else eos[0],
                              name=name or hf.get("_name_or_path") or "longcat-flash-custom")


# ---------------------------------------------------------------------------
# Modules (the published keys; the held FFN experts stacked)
# ---------------------------------------------------------------------------


class _Gate:
    """The router under DeepSeek-V2's names, as ``deepseek_v2._route`` reads
    a router (read through the module at each use)."""

    def __init__(self, router: nn.Module):
        self.router = router

    @property
    def weight(self) -> Tensor:
        return self.router.classifier.weight

    @property
    def e_score_correction_bias(self) -> Tensor:
        return self.router.e_score_correction_bias


class _MoE(nn.Module):
    """The router over all FFN and identity experts (``router.classifier``,
    ``router.e_score_correction_bias``; ``gate`` its view under DeepSeek-V2's
    names) and the held FFN experts stacked (local index e is expert
    ``held[0] + e``)."""

    def __init__(self, cfg: LongcatFlashConfig):
        super().__init__()
        r = cfg.routing
        D, Fw = cfg.hidden_size, cfg.expert_ffn_hidden_size
        self.router = nn.Module()
        self.router.classifier = nn.Module()
        self.router.classifier.weight = empty_param(r.width, D)
        self.router.e_score_correction_bias = empty_param(r.width)
        self.experts = nn.Module()
        self.experts.gate_up_proj = empty_param(r.n_held, 2 * Fw, D)
        self.experts.down_proj = empty_param(r.n_held, D, Fw)

    @property
    def gate(self) -> _Gate:
        return _Gate(self.router)


class _DoubleLayer(nn.Module):
    def __init__(self, cfg: LongcatFlashConfig):
        super().__init__()
        D = cfg.hidden_size
        self.mlp = _MoE(cfg)
        self.self_attn = nn.ModuleList(_MLA(cfg) for _ in range(2))
        self.mlps = nn.ModuleList(_MLP(D, cfg.ffn_hidden_size) for _ in range(2))
        self.input_layernorm = nn.ModuleList(RMSNorm(D, cfg.rms_norm_eps) for _ in range(2))
        self.post_attention_layernorm = nn.ModuleList(RMSNorm(D, cfg.rms_norm_eps)
                                                      for _ in range(2))


class _Shortcut:
    """The first half's expert layer as DeepSeek-V2's segments read one: the
    router and held experts of ``layer.mlp``, with ``mlps[0]`` as the part
    added to the residual at once (``shared_experts``)."""

    def __init__(self, layer: _DoubleLayer):
        self.layer = layer

    @property
    def gate(self):
        return self.layer.mlp.gate

    @property
    def experts(self):
        return self.layer.mlp.experts

    @property
    def shared_experts(self):
        return self.layer.mlps[0]


class _Half:
    """Half ``half`` of a double layer as DeepSeek-V2's decode segments read
    a layer (read through the module at each use, so weights put in place
    later are seen)."""

    def __init__(self, layer: _DoubleLayer, half: int):
        self.layer, self.half = layer, half

    @property
    def input_layernorm(self):
        return self.layer.input_layernorm[self.half]

    @property
    def self_attn(self):
        return self.layer.self_attn[self.half]

    @property
    def post_attention_layernorm(self):
        return self.layer.post_attention_layernorm[self.half]

    @property
    def mlp(self):
        return _Shortcut(self.layer) if self.half == 0 else self.layer.mlps[1]


class LongcatFlash(nn.Module):
    """LongCat-Flash weights under the published keys (the held experts
    stacked).  Built empty: weights come from :func:`init_longcat`,
    :func:`longcat_from_hf` or ``load_state_dict(assign=True)``."""

    roadmap_item = "F15"       # what the port does not run with it yet

    def __init__(self, cfg: LongcatFlashConfig):
        super().__init__()
        self.config = cfg
        self.model = nn.Module()
        self.model.embed_tokens = nn.Module()
        self.model.embed_tokens.weight = empty_param(cfg.vocab_size, cfg.hidden_size)
        self.model.layers = nn.ModuleList(_DoubleLayer(cfg) for _ in range(cfg.num_layers))
        self.model.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.lm_head = nn.Module()
        self.lm_head.weight = empty_param(cfg.vocab_size, cfg.hidden_size)
        # The decode segments' layers: both halves of each double layer.
        self.sublayers = [_Half(layer, h) for layer in self.model.layers for h in (0, 1)]
        # A beam decode step's eager work, in order, by half layer: the
        # first attention, the experts, the second attention.
        self.cuts: List[Tuple[str, int]] = []
        for i in range(cfg.num_layers):
            self.cuts += [("attn", 2 * i), ("moe", 2 * i), ("attn", 2 * i + 1)]
        self.decode_graphs = DecodeGraphs()
        self._rope: Dict[torch.device, Tensor] = {}

    @property
    def decode_segments(self) -> int:
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


def init_longcat(cfg: LongcatFlashConfig, seed: int = 0) -> LongcatFlash:
    """Seeded fp32 weights on the CPU: matrices N(0, 0.02), norm scales 1,
    the selection bias N(0, ``BIAS_STD``)."""
    model = LongcatFlash(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "norm" in name:
                p.fill_(1.0)
            elif name.endswith("e_score_correction_bias"):
                p.normal_(0.0, BIAS_STD, generator=g)
            else:
                p.normal_(0.0, 0.02, generator=g)
    return model


def longcat_from_hf(state_dict: Mapping[str, Tensor], cfg: LongcatFlashConfig) -> LongcatFlash:
    """A model from a published ``LongcatFlashForCausalLM`` state dict: each
    layer's held FFN experts ``mlp.experts.{e}.{gate,up,down}_proj.weight``
    (e in ``experts_held``) stacked into ``gate_up_proj`` [E_held, 2F, D]
    and ``down_proj`` [E_held, D, F]; the other experts' keys and the
    multi-token-prediction module (``model.mtp.*``) dropped."""
    lo, hi = cfg.experts_held
    sd = {k: v.detach() for k, v in state_dict.items()
          if ".mlp.experts." not in k and not k.startswith("model.mtp.")}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}.mlp.experts."
        per = [[state_dict[f"{p}{e}.{n}_proj.weight"] for n in ("gate", "up", "down")]
               for e in range(lo, hi)]
        sd[p + "gate_up_proj"] = torch.stack([torch.cat([g, u]) for g, u, _ in per])
        sd[p + "down_proj"] = torch.stack([d for _, _, d in per])
    with torch.device("meta"):
        model = LongcatFlash(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    return model


def is_longcat(name_or_path: str) -> bool:
    """Whether a language-model name or directory is of this family."""
    if name_or_path in LONGCAT_PRESETS:
        return True
    cfg = os.path.join(name_or_path, "config.json")
    if os.path.isdir(name_or_path) and os.path.exists(cfg):
        with open(cfg) as f:
            return json.load(f).get("model_type") == "longcat_flash"
    return False


def load_longcat(name_or_path: str,
                 experts_held: Optional[Tuple[int, int]] = None) -> LongcatFlash:
    """Resolve a LongCat-Flash without the network: a local directory with
    the published ``config.json`` and ``*.safetensors`` weights (holding
    ``experts_held``, default all); else, for a preset name, seeded weights
    (:func:`init_longcat`, seed 0), with a warning for the published model."""
    from clipcap_tpu_torch.models.hf_import import load_torch_state_dict

    if os.path.isdir(name_or_path):
        with open(os.path.join(name_or_path, "config.json")) as f:
            cfg = longcat_config_from_hf(json.load(f), experts_held, name=name_or_path)
        files = sorted(glob.glob(os.path.join(name_or_path, "*.safetensors")))
        if not files:
            raise FileNotFoundError(f"no weights file in {name_or_path}")
        sd = {}
        for path in files:
            sd.update(load_torch_state_dict(path))
        return longcat_from_hf(sd, cfg)
    if name_or_path not in LONGCAT_PRESETS:
        raise ValueError(f"cannot resolve language model '{name_or_path}'")
    if name_or_path != "longcat-flash-test":
        warnings.warn(
            f"No pretrained weights for '{name_or_path}' on disk. Using RANDOM "
            "initialization — fine for benchmarks, wrong for pretrained captioning.")
    return init_longcat(LONGCAT_PRESETS[name_or_path], seed=0)


# ---------------------------------------------------------------------------
# The beam cache
# ---------------------------------------------------------------------------


def longcat_beam_cache(cfg: LongcatFlashConfig, bp, groups: int, prefix_len: int,
                       tile_major: bool, dtype, device) -> Tuple[List[Tensor], None]:
    """``gpt2.gpt2_beam_cache``'s contract with the folded-prefix latent
    cache alone (one a latent attention, 2·``num_layers``): the other forms
    raise before anything is allocated."""
    what = folded_cache_only(bp, tile_major)
    if what:
        _unsupported(f"{what} in beam search")
    return init_latent_cache(cfg, groups * bp.beam_size, bp.max_new_tokens, dtype,
                             bp.beam_size, prefix_len, device), None


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _prologue(model: LongcatFlash, half: int, x: Tensor, rope: Tensor, K: int) -> tuple:
    """Half layer ``half``'s latent-attention prologue: ``(x, rope, q, row)``."""
    return dsv2._mla_prologue(model.sublayers[half], model.config, x, rope, K)


def _beam_decode_layers(model: LongcatFlash, x: Tensor, kv_cache: List[Tensor], mask: Tensor,
                        slot: int, K: int, rope: Tensor, steps) -> Tensor:
    """The double layers and final norm of one beam decode step → [B, 1, D]:
    the segments run through ``steps``; each latent attention's cache write
    and ``mla_decode``, and each layer's grouped experts, eagerly between
    them (``models.deepseek_v2``'s)."""
    cfg = model.config

    def segment(j, carry, *inputs):
        return dsv2._decode_segment(model, j, carry, inputs, K, prologue=_prologue,
                                    layers=model.sublayers, shortcut=True)

    carry = steps.run(segment, 0, x, rope)
    for j, (kind, half) in enumerate(model.cuts):
        if kind == "attn":
            out = dsv2._eager_attn(kv_cache[half], carry, mask, slot, K, cfg)
        else:
            out = dsv2._eager_experts(model.sublayers[half], carry)
        carry = steps.run(segment, j + 1, out)
    return carry[0]


def longcat_apply(model: LongcatFlash, *, input_ids: Optional[Tensor] = None,
                  inputs_embeds: Optional[Tensor] = None,
                  kv_cache: Optional[List[Tensor]] = None, cache_index: int = 0,
                  dtype=torch.float32, return_logits: bool = True,
                  beam_size: Optional[int] = None, ancestry: Optional[Tensor] = None,
                  cache_base: int = 0, shared_kv=None, shared_len=None, graphs=None):
    """LongCat-Flash forward → ``(logits_or_hidden, kv_cache)``, with
    ``gpt2.gpt2_apply``'s arguments.

    ``kv_cache=None``: causal attention over the input.  Cached, without
    ``ancestry``: the input's latent rows are written at slots
    ``[cache_index, cache_index + S)`` of each latent attention's cache and
    attention reads the slots ``[0, cache_index + S)`` (the prefill, and
    plain decoding).  Beam decode (``beam_size`` K, ``ancestry`` [B, Tl],
    ``cache_base`` P, one token): the absorbed step over the folded beam
    cache, its segments run as ``gpt2_apply``'s.  The consolidated shared
    prefix and the replicated beam prefill raise ``NotImplementedError``."""
    cfg = model.config
    if shared_kv is not None or shared_len is not None:
        _unsupported("a consolidated shared-prefix cache")
    if inputs_embeds is None:
        inputs_embeds = embed(model.model.embed_tokens.weight, input_ids, dtype)
    x = inputs_embeds.to(dtype)
    B, S, D = x.shape
    dev = x.device
    offset = cache_index if kv_cache is not None else 0
    if S > 1 and offset != 0:
        raise ValueError("cached prefill (S > 1) requires cache_index == 0")
    rope = model.rope_rows(offset + S, dev)[offset:offset + S]           # [S, 2, r]

    if kv_cache is not None and ancestry is not None:
        with beam_step("longcat.blocks", x, ancestry, beam_size, kv_cache[0].shape[1], offset,
                       cache_base, graphs) as (mask, slot, steps):
            x = _beam_decode_layers(model, x, kv_cache, mask, slot, beam_size, rope, steps)
        return (longcat_logits(model, x) if return_logits else x), kv_cache
    if graphs is not None:
        raise ValueError("graphs serve beam decode steps only (ancestry and one token)")
    if beam_size is not None:
        _unsupported("a replicated beam prefix (fold_prefix=False)")

    bias = causal_bias(S, offset + S, offset, device=dev)

    def attend(i: int, half: int, x: Tensor) -> Tensor:
        layer = model.model.layers[i]
        cache = None if kv_cache is None else kv_cache[2 * i + half]
        return dsv2._attend(layer.self_attn[half], layer.input_layernorm[half](x), cfg, rope,
                            bias, cache, offset)

    with annotate("longcat.blocks"):
        for i, layer in enumerate(model.model.layers):
            x = x + attend(i, 0, x)
            h = layer.post_attention_layernorm[0](x)
            shortcut = dsv2._routed(layer.mlp, h.reshape(-1, D), cfg).view_as(h)
            x = x + layer.mlps[0](h)
            x = x + attend(i, 1, x)
            x = x + layer.mlps[1](layer.post_attention_layernorm[1](x)) + shortcut
    x = model.model.norm(x)
    return (longcat_logits(model, x) if return_logits else x), kv_cache


def longcat_embed_tokens(model: LongcatFlash, token_ids: Tensor, dtype=torch.float32) -> Tensor:
    return embed(model.model.embed_tokens.weight, token_ids, dtype)


def longcat_logits(model: LongcatFlash, hidden: Tensor) -> Tensor:
    """Project hidden states onto the vocabulary (the untied ``lm_head``)."""
    with annotate("longcat.lm_head"):
        return hidden @ model.lm_head.weight.to(hidden.dtype).t()
