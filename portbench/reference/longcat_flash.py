"""Plain LongCat-Flash (the published ``modeling_longcat_flash.py`` forward,
no cache).

Weights under the port's keys (the published ones, ``nn.Linear``'s ``[out,
in]`` layout; each layer's held FFN experts stacked:
``mlp.experts.gate_up_proj`` [E_held, 2F, D], gate | up, and
``.down_proj`` [E_held, D, F]).  The weights may be held in bf16 (the model
at the benchmark's share takes 111.8 GB in float32, more than the card):
every product upcasts its matrix at its use and computes in float32
(``Numerics``; TF32 off under ``numerics.fp32()``), so at most one matrix
of one double layer is held in float32 at a time.

Per double layer, exactly as published (the shortcut-connected MoE)::

    x += attn0(ln_in0(x));  h = ln_post0(x);  s = MoE(h);  x += mlp0(h)
    x += attn1(ln_in1(x));  x = x + mlp1(ln_post1(x)) + s

* RMSNorm in float32 (eps ``rms_norm_eps``; the LoRA norms 1e-6).
* Latent attention with the keys and values decompressed from the latent:
  ``q = q_b(RMSNorm(q_a(h)))·√(D / q_lora)``; the latent ``c`` of
  ``kv_a_proj_with_mqa``, normalised, × √(D / kv_lora), through
  ``kv_b_proj`` → per head ``k_nope | v``; RoPE on the interleaved pairs
  of ``q_pe`` and the shared ``k_pe`` (complex rotations at
  ``rope_theta``), scale ``(nope + rope)^-0.5``, causal over the whole
  sequence.
* The mixture of experts: float32 router logits over all
  ``n_routed_experts`` + ``zero_expert_num`` outputs, softmax, the top
  ``moe_topk`` by score + ``e_score_correction_bias``, weights the unbiased
  scores × ``routed_scaling_factor``; each held FFN expert (``experts_held``
  [lo, hi)) looped over and applied to its tokens; each identity expert
  returns ``h``.  The other FFN experts' part is left out, as on the chip
  that holds this share.
* Dense SwiGLU MLPs; the final RMSNorm and the untied LM head.

The input is embeddings (a prefix, then token embeddings), as ClipCap
feeds it.  ``cfg`` is a dict of the model's ``config.json`` keys,
``n_routed_experts`` the router's FFN experts, with ``experts_held``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.numerics import Numerics

Tensor = torch.Tensor

LORA_EPS = 1e-6         # q_a_layernorm's and kv_a_layernorm's eps


def _rms(x: Tensor, w: Tensor, eps: float) -> Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _mlp(W: dict, p: str, x: Tensor, num: Numerics) -> Tensor:
    g = num.linear(x, W[p + "gate_proj.weight"].t())
    u = num.linear(x, W[p + "up_proj.weight"].t())
    return num.linear(F.silu(g) * u, W[p + "down_proj.weight"].t())


def _rotation(cfg: dict, S: int, device) -> Tensor:
    """[S, r/2] complex: each position's rotation of each pair."""
    r = cfg["qk_rope_head_dim"]
    i = torch.arange(0, r, 2, dtype=torch.float64) / r
    freq = (float(cfg["rope_theta"]) ** -i).float().to(device)
    ang = torch.arange(S, device=device, dtype=torch.float32)[:, None] * freq[None]
    return torch.polar(torch.ones_like(ang), ang)


def _rope(x: Tensor, rot: Tensor) -> Tensor:
    """Rotate the interleaved pairs (2j, 2j+1) of ``x`` [..., S, (H,) r]."""
    z = torch.view_as_complex(x.float().reshape(*x.shape[:-1], -1, 2).contiguous())
    return torch.view_as_real(z * rot).flatten(-2)


def _mla(W: dict, a: str, h: Tensor, cfg: dict, rot: Tensor, num: Numerics) -> Tensor:
    B, S, D = h.shape
    H = cfg["num_attention_heads"]
    nope, r, vd, C = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                      cfg["kv_lora_rank"])
    q = num.linear(_rms(num.linear(h, W[a + "q_a_proj.weight"].t()),
                        W[a + "q_a_layernorm.weight"], LORA_EPS), W[a + "q_b_proj.weight"].t())
    if cfg.get("mla_scale_q_lora", True):
        q = q * (D / cfg["q_lora_rank"]) ** 0.5
    q = q.view(B, S, H, nope + r)
    ckv = num.linear(h, W[a + "kv_a_proj_with_mqa.weight"].t())
    lat = _rms(ckv[..., :C], W[a + "kv_a_layernorm.weight"], LORA_EPS)
    if cfg.get("mla_scale_kv_lora", True):
        lat = lat * (D / C) ** 0.5
    kv = num.linear(lat, W[a + "kv_b_proj.weight"].t()).view(B, S, H, nope + vd)
    q_pe = _rope(q[..., nope:], rot[:, None])                        # [B, S, H, r]
    k_pe = _rope(ckv[..., C:], rot)                                   # [B, S, r]
    att = (torch.einsum("bshd,bthd->bhst", q[..., :nope], kv[..., :nope])
           + torch.einsum("bshd,btd->bhst", q_pe, k_pe)) * (nope + r) ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", att, kv[..., nope:]).reshape(B, S, H * vd)
    return num.linear(o, W[a + "o_proj.weight"].t())


def _moe(W: dict, p: str, x: Tensor, cfg: dict, num: Numerics) -> Tensor:
    """The shortcut branch: the held FFN experts' part and the identity
    experts' part of the routed sum."""
    B, S, D = x.shape
    h = x.reshape(-1, D)
    E, F_ = cfg["n_routed_experts"], cfg["expert_ffn_hidden_size"]
    scores = torch.softmax(num.linear(h, W[p + "router.classifier.weight"].t()), dim=-1)
    idx = torch.topk(scores + W[p + "router.e_score_correction_bias"].float(),
                     cfg["moe_topk"], dim=-1).indices
    w = scores.gather(-1, idx) * cfg["routed_scaling_factor"]
    out = (w * (idx >= E)).sum(-1, keepdim=True) * h                 # the identity experts
    w13, w2 = W[p + "experts.gate_up_proj"], W[p + "experts.down_proj"]
    lo, hi = cfg["experts_held"]
    for e in range(lo, hi):
        tok, kk = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = num.linear(h[tok], w13[e - lo].t())
        y = num.linear(F.silu(gu[:, :F_]) * gu[:, F_:], w2[e - lo].t())
        out.index_add_(0, tok, y * w[tok, kk, None])
    return out.view(B, S, D)


def double_layer(W: dict, i: int, x: Tensor, cfg: dict, rot: Tensor, num: Numerics) -> Tensor:
    """Double layer ``i`` over ``x`` [B, S, D] float32."""
    p, eps = f"model.layers.{i}.", cfg["rms_norm_eps"]
    x = x + _mla(W, p + "self_attn.0.", _rms(x, W[p + "input_layernorm.0.weight"], eps), cfg,
                 rot, num)
    h = _rms(x, W[p + "post_attention_layernorm.0.weight"], eps)
    shortcut = _moe(W, p + "mlp.", h, cfg, num)
    x = x + _mlp(W, p + "mlps.0.", h, num)
    x = x + _mla(W, p + "self_attn.1.", _rms(x, W[p + "input_layernorm.1.weight"], eps), cfg,
                 rot, num)
    h = _rms(x, W[p + "post_attention_layernorm.1.weight"], eps)
    return x + _mlp(W, p + "mlps.1.", h, num) + shortcut


def longcat_hidden(W: dict, embeds: Tensor, cfg: dict, num: Numerics) -> Tensor:
    """``[B, S, D]`` input embeddings (positions 0..S-1) → the hidden states
    after the final norm, float32."""
    rot = _rotation(cfg, embeds.shape[1], embeds.device)
    x = embeds.float()
    for i in range(cfg["num_layers"]):
        x = double_layer(W, i, x, cfg, rot, num)
    return _rms(x, W["model.norm.weight"], cfg["rms_norm_eps"])


def lm_logits(W: dict, hidden: Tensor, num: Numerics) -> Tensor:
    """The untied LM head: ``hidden @ lm_headᵀ`` in float32."""
    return num.linear(hidden, W["lm_head.weight"].t())


def token_embeds(W: dict, ids: Tensor) -> Tensor:
    return W["model.embed_tokens.weight"][ids].float()
