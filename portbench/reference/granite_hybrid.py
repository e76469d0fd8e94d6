"""Plain Granite-4.0-H (the published ``granitemoehybrid`` forward, no cache).

Weights under the port's keys (``nn.Linear``'s ``[out, in]`` layout; each
layer's held experts stacked: ``mlp.experts.gate_up_proj`` [E_held, 2F, D],
gate | up, and ``.down_proj`` [E_held, D, F]; the router ``mlp.gate``; the
shared MLP ``mlp.shared_experts.input_linear`` (gate | up) and
``.output_linear``).  The weights may be held in bf16 (the model at the
benchmark's share takes 33.7 GB in float32): every product upcasts its
matrix at its use and computes in float32 (``Numerics``; TF32 off under
``numerics.fp32()``).

The input embeddings × ``embedding_multiplier``; per layer RMSNorm
(float32), then Mamba-2 or attention, the branch × ``residual_multiplier``
added; RMSNorm, then the routed experts + the shared MLP, the branch ×
``residual_multiplier`` added.

* Mamba-2, token by token from a zero state: ``in_proj`` → z | xBC | dt;
  the causal depthwise convolution of kernel 4 written out as the weighted
  sum of the four positions, plus its bias, SiLU → x | B | C (one group);
  ``dt = softplus(dt + dt_bias)``, per position ``h ← exp(dt·A)·h + dt·x ⊗
  B`` with ``A = −exp(A_log)``, ``y = h·C + D·x``; ``w ·
  RMSNorm(y · SiLU(z))`` and ``out_proj``.
* Grouped-query attention without rotation, causal over the whole
  sequence: query head j reads K|V head ``j // (H / Hkv)``, scale
  ``attention_multiplier``.
* The mixture of experts: float32 router logits over all
  ``num_local_experts``, the top ``num_experts_per_tok``, their softmax
  (the published gating); each held expert (``experts_held`` [lo, hi))
  looped over and applied to its tokens; the shared MLP.  The other
  experts' part is left out, as on the chip that holds this share.

The final RMSNorm and the head tied to the embedding, the logits ÷
``logits_scaling``.  The input is embeddings (a prefix, then token
embeddings), as ClipCap feeds it.  ``cfg`` is a dict of the model's
``config.json`` keys, ``num_local_experts`` the router's width, with
``experts_held``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.numerics import Numerics

Tensor = torch.Tensor


def _rms(x: Tensor, w: Tensor, eps: float) -> Tensor:
    x = x.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def _swiglu(W: dict, gate_up: str, down: str, x: Tensor, num: Numerics) -> Tensor:
    g, u = num.linear(x, W[gate_up].t()).chunk(2, dim=-1)
    return num.linear(F.silu(g) * u, W[down].t())


def _mamba(W: dict, a: str, h: Tensor, cfg: dict, num: Numerics) -> Tensor:
    B, S, _ = h.shape
    H, P, N = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    inner = cfg["mamba_expand"] * cfg["hidden_size"]
    z, xbc, dt = num.linear(h, W[a + "in_proj.weight"].t()).split([inner, inner + 2 * N, H], -1)
    w, T = W[a + "conv1d.weight"].float(), W[a + "conv1d.weight"].shape[-1]
    xp = F.pad(xbc, (0, 0, T - 1, 0))
    conv = sum(xp[:, j:j + S] * w[:, 0, j] for j in range(T)) + W[a + "conv1d.bias"].float()
    x, Bm, Cm = F.silu(conv).split([inner, N, N], -1)
    x = x.view(B, S, H, P)
    step = F.softplus(dt + W[a + "dt_bias"].float())                           # [B, S, H]
    A = -W[a + "A_log"].float().exp()
    state = torch.zeros(B, H, P, N, device=h.device)
    ys = []
    for t in range(S):
        decay = torch.exp(step[:, t] * A)[..., None, None]
        state = state * decay + (step[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, None, None]
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cm[:, t]))
    y = torch.stack(ys, 1) + W[a + "D"].float()[:, None] * x                  # [B, S, H, P]
    g = y.reshape(B, S, inner) * F.silu(z)
    g = _rms(g, W[a + "norm.weight"], cfg["rms_norm_eps"])
    return num.linear(g, W[a + "out_proj.weight"].t())


def _gqa(W: dict, a: str, h: Tensor, cfg: dict, num: Numerics) -> Tensor:
    B, S, D = h.shape
    H, Hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = D // H
    q = num.linear(h, W[a + "q_proj.weight"].t()).view(B, S, H, Dh)
    k, v = (num.linear(h, W[a + f"{n}_proj.weight"].t()).view(B, S, Hkv, Dh)
            .repeat_interleave(H // Hkv, dim=2) for n in "kv")
    att = torch.einsum("bshd,bthd->bhst", q, k) * cfg["attention_multiplier"]
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhst,bthd->bshd", att, v).reshape(B, S, H * Dh)
    return num.linear(o, W[a + "o_proj.weight"].t())


def _moe(W: dict, p: str, x: Tensor, cfg: dict, num: Numerics) -> Tensor:
    B, S, D = x.shape
    h = x.reshape(-1, D)
    logits = num.linear(h, W[p + "gate.weight"].t())
    top, idx = torch.topk(logits, cfg["num_experts_per_tok"], dim=-1)
    w = torch.softmax(top, dim=-1)
    out = torch.zeros_like(h)
    w13, w2 = W[p + "experts.gate_up_proj"], W[p + "experts.down_proj"]
    lo, hi = cfg["experts_held"]
    for e in range(lo, hi):
        tok, kk = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        g, u = num.linear(h[tok], w13[e - lo].t()).chunk(2, dim=-1)
        y = num.linear(F.silu(g) * u, w2[e - lo].t())
        out.index_add_(0, tok, y * w[tok, kk, None])
    s = p + "shared_experts."
    shared = _swiglu(W, s + "input_linear.weight", s + "output_linear.weight", h, num)
    return (out + shared).view(B, S, D)


def granite_hidden(W: dict, embeds: Tensor, cfg: dict, num: Numerics) -> Tensor:
    """``[B, S, D]`` input embeddings (positions 0..S-1) → the hidden states
    after the final norm, float32."""
    eps, m = cfg["rms_norm_eps"], cfg["residual_multiplier"]
    x = embeds.float() * cfg["embedding_multiplier"]
    for i, kind in enumerate(cfg["layer_types"]):
        p = f"model.layers.{i}."
        h = _rms(x, W[p + "input_layernorm.weight"], eps)
        if kind == "mamba":
            x = x + _mamba(W, p + "mamba.", h, cfg, num) * m
        else:
            x = x + _gqa(W, p + "self_attn.", h, cfg, num) * m
        h = _rms(x, W[p + "post_attention_layernorm.weight"], eps)
        x = x + _moe(W, p + "mlp.", h, cfg, num) * m
    return _rms(x, W["model.norm.weight"], eps)


def lm_logits(W: dict, hidden: Tensor, num: Numerics, cfg: dict) -> Tensor:
    """The head tied to the embedding, ÷ ``logits_scaling``, in float32."""
    return num.linear(hidden, W["model.embed_tokens.weight"].t()) / cfg["logits_scaling"]


def token_embeds(W: dict, ids: Tensor) -> Tensor:
    return W["model.embed_tokens.weight"][ids].float()
