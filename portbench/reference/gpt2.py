"""Plain GPT-2 (HF ``GPT2LMHeadModel`` forward, no cache).

Weights under HF ``GPT2Model`` keys (``wte.weight``, ``h.{i}.attn.c_attn.weight``
stored ``[in, out]`` as HF's ``Conv1D`` ...), float32.  Causal attention over
the whole sequence, the tanh GELU (``gelu_new``), the LM head tied to
``wte``.  The input is embeddings (a prefix followed by token embeddings),
as ClipCap feeds it.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.clip_vit import layer_norm
from portbench.reference.numerics import Numerics

Tensor = torch.Tensor


def gelu_new(x: Tensor) -> Tensor:
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def gpt2_hidden(W: dict, embeds: Tensor, cfg: dict, num: Numerics) -> Tensor:
    """``[B, S, D]`` input embeddings (positions 0..S-1) → final hidden
    states after ``ln_f``, float32."""
    B, S, D = embeds.shape
    H, eps = cfg["n_head"], cfg["layer_norm_epsilon"]
    x = embeds.float() + W["wpe.weight"][:S].float()
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for i in range(cfg["n_layer"]):
        pre = f"h.{i}."
        h = layer_norm(x, W[pre + "ln_1.weight"], W[pre + "ln_1.bias"], eps)
        qkv = num.linear(h, W[pre + "attn.c_attn.weight"], W[pre + "attn.c_attn.bias"])
        q, k, v = (t.reshape(B, S, H, D // H).transpose(1, 2) for t in qkv.split(D, -1))
        att = (q @ k.transpose(-1, -2)) / math.sqrt(D // H)
        att = torch.softmax(att.masked_fill(~causal, float("-inf")), dim=-1)
        o = (att @ v).transpose(1, 2).reshape(B, S, D)
        x = x + num.linear(o, W[pre + "attn.c_proj.weight"], W[pre + "attn.c_proj.bias"])
        h = layer_norm(x, W[pre + "ln_2.weight"], W[pre + "ln_2.bias"], eps)
        h = gelu_new(num.linear(h, W[pre + "mlp.c_fc.weight"], W[pre + "mlp.c_fc.bias"]))
        x = x + num.linear(h, W[pre + "mlp.c_proj.weight"], W[pre + "mlp.c_proj.bias"])
    return layer_norm(x, W["ln_f.weight"], W["ln_f.bias"], eps)


def lm_logits(W: dict, hidden: Tensor, num: Numerics) -> Tensor:
    """The tied LM head: ``hidden @ wteᵀ`` in float32."""
    return num.linear(hidden, W["wte.weight"].t())


def token_embeds(W: dict, ids: Tensor) -> Tensor:
    return W["wte.weight"].float()[ids]
