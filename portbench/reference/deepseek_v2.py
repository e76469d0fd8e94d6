"""Plain DeepSeek-V2 (DeepSeek's ``modeling_deepseek.py`` forward, no cache).

Weights under HF ``DeepseekV2ForCausalLM`` keys, ``nn.Linear``'s ``[out,
in]`` layout, with each MoE layer's routed experts stacked:
``model.layers.{i}.mlp.experts.gate_up_proj`` [E, 2F, D] (gate | up) and
``.down_proj`` [E, D, F].  The weights may be held in bf16 (at
DeepSeek-V2-Lite's widths the model would take 62.8 GB in float32): every
product upcasts its matrix at its use and computes in float32 (``Numerics``;
TF32 off under ``numerics.fp32()``).

Per layer: RMSNorm (float32); multi-head latent attention with the keys
and values decompressed from the normalised latent, RoPE on the
interleaved pairs of ``q_pe`` and the shared ``k_pe`` (as complex
rotations, with YaRN's frequencies and attention factor), the softmax scale
``q_head_dim^-0.5 · mscale²``, causal over the whole sequence; then a
SwiGLU MLP, or the mixture of experts: a float32 softmax router, greedy
top-k, every routed expert looped over and applied to its tokens, weighed
by the unnormalised probability, plus the shared experts.  The final
RMSNorm and the untied LM head.  The input is embeddings (a prefix, then
token embeddings), as ClipCap feeds it.  ``cfg`` is the configuration's
dict of HF ``config.json`` keys.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.numerics import Numerics

Tensor = torch.Tensor


def _rms(x: Tensor, w: Tensor, eps: float) -> Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _mscale(scale: float, m: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * m * math.log(scale) + 1.0


def rope_frequencies(cfg: dict) -> Tensor:
    """[r/2] float32: RoPE's inverse frequencies, blended by YaRN between
    the interpolated (÷ factor) and the original ones over the dimensions
    whose wavelengths lie between ``beta_fast`` and ``beta_slow``
    rotations of the original context."""
    r, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    i = torch.arange(0, r, 2, dtype=torch.float64) / r
    extra = base ** -i
    ys = cfg.get("rope_scaling")
    if not ys:
        return extra.float()
    s, n0 = float(ys["factor"]), ys["original_max_position_embeddings"]

    def dim(rot):
        return r * math.log(n0 / (rot * 2 * math.pi)) / (2 * math.log(base))

    lo = max(math.floor(dim(ys["beta_fast"])), 0)
    hi = min(math.ceil(dim(ys["beta_slow"])), r - 1)
    hi = hi + 0.001 if hi == lo else hi
    ramp = ((torch.arange(r // 2, dtype=torch.float64) - lo) / (hi - lo)).clamp(0, 1)
    return (extra / s * ramp + extra * (1 - ramp)).float()


def attention_scale(cfg: dict) -> float:
    scale = (cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]) ** -0.5
    ys = cfg.get("rope_scaling")
    if ys and ys.get("mscale_all_dim"):
        scale *= _mscale(ys["factor"], ys["mscale_all_dim"]) ** 2
    return scale


def _rotation(cfg: dict, S: int, device) -> Tensor:
    """[S, r/2] complex: each position's rotation of each pair."""
    ang = torch.arange(S, device=device, dtype=torch.float32)[:, None] * \
        rope_frequencies(cfg).to(device)[None]
    ys = cfg.get("rope_scaling")
    a = (_mscale(ys["factor"], ys.get("mscale", 1)) / _mscale(ys["factor"],
                                                                ys.get("mscale_all_dim", 0))
         if ys else 1.0)
    return torch.polar(torch.full_like(ang, a), ang)


def _rope(x: Tensor, rot: Tensor) -> Tensor:
    """Rotate the interleaved pairs (2j, 2j+1) of ``x`` [..., S, (H,) r]."""
    z = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(z * rot).flatten(-2)


def _mlp(W: dict, p: str, x: Tensor, num: Numerics) -> Tensor:
    g = num.linear(x, W[p + "gate_proj.weight"].t())
    u = num.linear(x, W[p + "up_proj.weight"].t())
    return num.linear(torch.nn.functional.silu(g) * u, W[p + "down_proj.weight"].t())


def _moe(W: dict, p: str, x: Tensor, cfg: dict, num: Numerics) -> Tensor:
    B, S, D = x.shape
    h = x.reshape(-1, D)
    F = cfg["moe_intermediate_size"]
    probs = torch.softmax(num.linear(h, W[p + "gate.weight"].t()), dim=-1)
    w, idx = torch.topk(probs, cfg["num_experts_per_tok"], dim=-1)
    if cfg.get("norm_topk_prob"):
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(h)
    w13, w2 = W[p + "experts.gate_up_proj"], W[p + "experts.down_proj"]
    for e in range(cfg["n_routed_experts"]):
        tok, k = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = num.linear(h[tok], w13[e].t())
        y = num.linear(torch.nn.functional.silu(gu[:, :F]) * gu[:, F:], w2[e].t())
        out.index_add_(0, tok, y * w[tok, k, None])
    return (out + _mlp(W, p + "shared_experts.", h, num)).view(B, S, D)


def dsv2_hidden(W: dict, embeds: Tensor, cfg: dict, num: Numerics) -> Tensor:
    """``[B, S, D]`` input embeddings (positions 0..S-1) → the hidden states
    after the final norm, float32."""
    B, S, D = embeds.shape
    H, eps = cfg["num_attention_heads"], cfg["rms_norm_eps"]
    nope, r, vd, C = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                      cfg["kv_lora_rank"])
    rot = _rotation(cfg, S, embeds.device)
    scale = attention_scale(cfg)
    causal = torch.ones(S, S, dtype=torch.bool, device=embeds.device).tril()
    x = embeds.float()
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        h = _rms(x, W[p + "input_layernorm.weight"], eps)
        q = num.linear(h, W[a + "q_proj.weight"].t()).view(B, S, H, nope + r)
        ckv = num.linear(h, W[a + "kv_a_proj_with_mqa.weight"].t())
        lat = _rms(ckv[..., :C], W[a + "kv_a_layernorm.weight"], 1e-6)
        kv = num.linear(lat, W[a + "kv_b_proj.weight"].t()).view(B, S, H, nope + vd)
        q_pe = _rope(q[..., nope:], rot[:, None])                        # [B, S, H, r]
        k_pe = _rope(ckv[..., C:], rot)                                   # [B, S, r]
        att = (torch.einsum("bshd,bthd->bhst", q[..., :nope], kv[..., :nope])
               + torch.einsum("bshd,btd->bhst", q_pe, k_pe)) * scale
        att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("bhst,bthd->bshd", att, kv[..., nope:]).reshape(B, S, H * vd)
        x = x + num.linear(o, W[a + "o_proj.weight"].t())
        h = _rms(x, W[p + "post_attention_layernorm.weight"], eps)
        if i >= cfg["first_k_dense_replace"] and i % cfg.get("moe_layer_freq", 1) == 0:
            x = x + _moe(W, p + "mlp.", h, cfg, num)
        else:
            x = x + _mlp(W, p + "mlp.", h, num)
    return _rms(x, W["model.norm.weight"], eps)


def lm_logits(W: dict, hidden: Tensor, num: Numerics) -> Tensor:
    """The untied LM head: ``hidden @ lm_headᵀ`` in float32."""
    return num.linear(hidden, W["lm_head.weight"].t())


def token_embeds(W: dict, ids: Tensor) -> Tensor:
    return W["model.embed_tokens.weight"][ids].float()
