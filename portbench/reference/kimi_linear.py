"""Plain Kimi-Linear (the Kimi Linear report's forward, no cache).

Weights under the port's keys (``nn.Linear``'s ``[out, in]`` layout; each
MoE layer's held experts stacked: ``mlp.experts.gate_up_proj`` [E_held, 2F,
D], gate | up, and ``.down_proj`` [E_held, D, F]).  The weights may be held
in bf16 (the model at the benchmark's share takes 31.6 GB in float32):
every product upcasts its matrix at its use and computes in float32
(``Numerics``; TF32 off under ``numerics.fp32()``).

Per layer: RMSNorm (float32); then a KDA layer or MLA; RMSNorm; then a
SwiGLU MLP or the mixture of experts.

* KDA, token by token from a zero state: for q, k, v the projection, the
  causal depthwise convolution of kernel 4 written out as the weighted sum
  of the four positions, SiLU; q and k divided by ``sqrt(Σx² + 1e-6)`` over
  each head, q times d^-1/2; the log decay ``g = −exp(A_log)·softplus(W_fb
  W_fa h + dt_bias)`` and ``β = sigmoid(W_b h)``; per position ``S ←
  exp(g) ⊙ S`` (by key channel), ``S ← S + β k (v − Sᵀk)ᵀ``, ``o = Sᵀq``;
  the gated norm ``RMSNorm(o)·w·sigmoid(W_gb W_ga h + b)`` and ``W_o``.
* MLA without rotation (NoPE): K and V decompressed from the normalised
  latent, the shared ``k_pe`` as projected, scale ``(nope + rope)^-0.5``,
  causal over the whole sequence.
* The mixture of experts: float32 router logits over all ``num_experts``,
  sigmoid scores, the top-k by score + ``e_score_correction_bias``,
  weights the unbiased scores renormalised over the chosen × the scaling
  factor; each held expert (``experts_held`` [lo, hi)) looped over and
  applied to its tokens; the shared expert.  The other experts' part is
  left out, as on the chip that holds this share.

The final RMSNorm and the untied LM head.  The input is embeddings (a
prefix, then token embeddings), as ClipCap feeds it.  ``cfg`` is a dict of
the model's ``config.json`` keys, ``num_experts`` the router's width, with
``experts_held``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.numerics import Numerics

Tensor = torch.Tensor

L2_EPS = 1e-6
LATENT_EPS = 1e-6       # kv_a_layernorm's eps (DeepSeek's RMSNorm default)


def _rms(x: Tensor, w: Tensor, eps: float) -> Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _mlp(W: dict, p: str, x: Tensor, num: Numerics) -> Tensor:
    g = num.linear(x, W[p + "gate_proj.weight"].t())
    u = num.linear(x, W[p + "up_proj.weight"].t())
    return num.linear(F.silu(g) * u, W[p + "down_proj.weight"].t())


def _conv(x: Tensor, w: Tensor) -> Tensor:
    """SiLU of the causal depthwise convolution: ``x`` [B, S, C], ``w`` [C,
    1, T] → ``Σ_j w[:, j]·x[t − T + 1 + j]`` (zeros before position 0)."""
    T = w.shape[-1]
    xp = F.pad(x.float(), (0, 0, T - 1, 0))
    S = x.shape[1]
    y = sum(xp[:, j:j + S] * w[:, 0, j].float() for j in range(T))
    return F.silu(y)


def _kda(W: dict, a: str, h: Tensor, cfg: dict, num: Numerics) -> Tensor:
    la = cfg["linear_attn_config"]
    H, d = la["num_heads"], la["head_dim"]
    B, S, _ = h.shape
    q, k, v = (_conv(num.linear(h, W[f"{a}{n}_proj.weight"].t()),
                     W[f"{a}{n}_conv1d.weight"]).view(B, S, H, d) for n in "qkv")
    q = q / torch.sqrt(q.pow(2).sum(-1, keepdim=True) + L2_EPS) * d ** -0.5
    k = k / torch.sqrt(k.pow(2).sum(-1, keepdim=True) + L2_EPS)
    f = num.linear(num.linear(h, W[a + "f_a_proj.weight"].t()), W[a + "f_b_proj.weight"].t())
    g = -W[a + "A_log"].float().exp()[:, None] * F.softplus(
        f.view(B, S, H, d) + W[a + "dt_bias"].float().view(H, d))
    beta = torch.sigmoid(num.linear(h, W[a + "b_proj.weight"].t()))          # [B, S, H]
    state = torch.zeros(B, H, d, d, device=h.device)
    out = []
    for t in range(S):
        state = state * g[:, t].exp()[..., None]
        u = (v[:, t] - torch.einsum("bhij,bhi->bhj", state, k[:, t])) * beta[:, t, :, None]
        state = state + k[:, t, ..., None] * u[..., None, :]
        out.append(torch.einsum("bhij,bhi->bhj", state, q[:, t]))
    o = torch.stack(out, 1)                                                   # [B, S, H, d]
    gate = num.linear(num.linear(h, W[a + "g_a_proj.weight"].t()), W[a + "g_b_proj.weight"].t(),
                      W[a + "g_b_proj.bias"])
    o = _rms(o, W[a + "o_norm.weight"], cfg["rms_norm_eps"]) * torch.sigmoid(gate).view(
        B, S, H, d)
    return num.linear(o.reshape(B, S, H * d), W[a + "o_proj.weight"].t())


def _mla(W: dict, a: str, h: Tensor, cfg: dict, num: Numerics) -> Tensor:
    B, S, _ = h.shape
    H = cfg["num_attention_heads"]
    nope, r, vd, C = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"],
                      cfg["kv_lora_rank"])
    q = num.linear(h, W[a + "q_proj.weight"].t()).view(B, S, H, nope + r)
    ckv = num.linear(h, W[a + "kv_a_proj_with_mqa.weight"].t())
    lat = _rms(ckv[..., :C], W[a + "kv_a_layernorm.weight"], LATENT_EPS)
    kv = num.linear(lat, W[a + "kv_b_proj.weight"].t()).view(B, S, H, nope + vd)
    att = (torch.einsum("bshd,bthd->bhst", q[..., :nope], kv[..., :nope])
           + torch.einsum("bshd,btd->bhst", q[..., nope:], ckv[..., C:])) * (nope + r) ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", att, kv[..., nope:]).reshape(B, S, H * vd)
    return num.linear(o, W[a + "o_proj.weight"].t())


def _moe(W: dict, p: str, x: Tensor, cfg: dict, num: Numerics) -> Tensor:
    B, S, D = x.shape
    h = x.reshape(-1, D)
    F_ = cfg["moe_intermediate_size"]
    scores = torch.sigmoid(num.linear(h, W[p + "gate.weight"].t()))
    idx = torch.topk(scores + W[p + "gate.e_score_correction_bias"].float(),
                     cfg["num_experts_per_token"], dim=-1).indices
    w = scores.gather(-1, idx)
    if cfg["moe_renormalize"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(h)
    w13, w2 = W[p + "experts.gate_up_proj"], W[p + "experts.down_proj"]
    lo, hi = cfg["experts_held"]
    for e in range(lo, hi):
        tok, kk = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        gu = num.linear(h[tok], w13[e - lo].t())
        y = num.linear(F.silu(gu[:, :F_]) * gu[:, F_:], w2[e - lo].t())
        out.index_add_(0, tok, y * w[tok, kk, None])
    return (out + _mlp(W, p + "shared_experts.", h, num)).view(B, S, D)


def kimi_hidden(W: dict, embeds: Tensor, cfg: dict, num: Numerics) -> Tensor:
    """``[B, S, D]`` input embeddings (positions 0..S-1) → the hidden states
    after the final norm, float32."""
    eps = cfg["rms_norm_eps"]
    kda = set(cfg["linear_attn_config"]["kda_layers"])
    x = embeds.float()
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}."
        h = _rms(x, W[p + "input_layernorm.weight"], eps)
        x = x + (_kda if i + 1 in kda else _mla)(W, p + "self_attn.", h, cfg, num)
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
