"""RoBERTa text encoder in PyTorch: the CLAP text tower.

Counterpart of ``clipcap_tpu/models/roberta.py``.  laion_clap's text
branch is a RoBERTa-base followed by a 2-layer MLP into the 512-d joint
audio-text space; it drives the audio rerank (cosine between a clip and
candidate captions).  :class:`Roberta` holds the weights under HF
``RobertaModel`` keys (``embeddings.word_embeddings.weight``,
``encoder.layer.{i}.attention.self.query.weight`` …, ``pooler.dense.*``),
so an HF state dict loads with ``load_state_dict`` and the JAX package's
``roberta_params_from_hf`` reads the port's.

As in HF ``RobertaModel``: position ids are ``padding_idx + cumsum(mask)``
on real tokens (pad positions keep the padding embedding); post-LN
blocks with exact GELU; ``pooler_output = tanh(dense(hidden[:, 0]))``.
Attention is eager (the JAX package computes it as an ``einsum``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from clipcap_tpu_torch.ops.layers import LayerNorm, Linear, empty_param

Tensor = torch.Tensor

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1
    name: str = "roberta-base"


def init_roberta(cfg: RobertaConfig, seed: int = 0) -> dict:
    """The JAX package's seeded tree (numpy; layers stacked, ``[in, out]``
    weights), drawn in its order."""
    rng = np.random.default_rng(seed)
    L, D, Fi = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size

    def lin(in_d, out_d):
        return {"w": rng.normal(0, 0.02, size=(L, in_d, out_d)).astype(np.float32),
                "b": np.zeros((L, out_d), np.float32)}

    def ln():
        return {"scale": np.ones((L, D), np.float32), "bias": np.zeros((L, D), np.float32)}

    return {
        "word_embeddings": rng.normal(0, 0.02, size=(cfg.vocab_size, D)).astype(np.float32),
        "position_embeddings": rng.normal(
            0, 0.02, size=(cfg.max_position_embeddings, D)).astype(np.float32),
        "token_type_embeddings": rng.normal(
            0, 0.02, size=(cfg.type_vocab_size, D)).astype(np.float32),
        "emb_ln": {"scale": np.ones((D,), np.float32), "bias": np.zeros((D,), np.float32)},
        "layers": {
            "q": lin(D, D), "k": lin(D, D), "v": lin(D, D),
            "attn_out": lin(D, D), "attn_ln": ln(),
            "fc1": lin(D, Fi), "fc2": lin(Fi, D), "out_ln": ln(),
        },
        "pooler": {"w": rng.normal(0, 0.02, size=(D, D)).astype(np.float32),
                   "b": np.zeros((D,), np.float32)},
    }


# ---------------------------------------------------------------------------
# Modules (HF RobertaModel keys)
# ---------------------------------------------------------------------------


def _table(n: int, d: int) -> nn.Module:
    m = nn.Module()
    m.weight = empty_param(n, d)
    return m


class _Embeddings(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        D = cfg.hidden_size
        self.word_embeddings = _table(cfg.vocab_size, D)
        self.position_embeddings = _table(cfg.max_position_embeddings, D)
        self.token_type_embeddings = _table(cfg.type_vocab_size, D)
        self.LayerNorm = LayerNorm(D, cfg.layer_norm_eps)


class _DenseNorm(nn.Module):
    """``dense`` + ``LayerNorm`` (HF ``RobertaSelfOutput`` / ``RobertaOutput``)."""

    def __init__(self, n_in: int, n_out: int, eps: float):
        super().__init__()
        self.dense = Linear(n_in, n_out)
        self.LayerNorm = LayerNorm(n_out, eps)


class _SelfAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.query = Linear(d, d)
        self.key = Linear(d, d)
        self.value = Linear(d, d)


class _Layer(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        D, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = nn.Module()
        self.attention.add_module("self", _SelfAttention(D))
        self.attention.output = _DenseNorm(D, D, eps)
        self.intermediate = nn.Module()
        self.intermediate.dense = Linear(D, cfg.intermediate_size)
        self.output = _DenseNorm(cfg.intermediate_size, D, eps)


class Roberta(nn.Module):
    def __init__(self, cfg: RobertaConfig):
        super().__init__()
        self.config = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = nn.Module()
        self.encoder.layer = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))
        self.pooler = nn.Module()
        self.pooler.dense = Linear(cfg.hidden_size, cfg.hidden_size)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------


def _block(x: Tensor, layer: _Layer, mask_bias: Tensor, heads: int) -> Tensor:
    B, S, D = x.shape
    Dh = D // heads
    att = layer.attention.get_submodule("self")
    q, k, v = (lin(x).reshape(B, S, heads, Dh) for lin in (att.query, att.key, att.value))
    logits = torch.einsum("bnhd,bmhd->bhnm", q, k) * (1.0 / np.sqrt(Dh))
    w = torch.softmax(logits.float() + mask_bias, dim=-1).to(x.dtype)
    attn = torch.einsum("bhnm,bmhd->bnhd", w, v).reshape(B, S, D)
    out = layer.attention.output
    x = out.LayerNorm(x + out.dense(attn))
    h = F.gelu(layer.intermediate.dense(x))           # exact GELU, as HF RoBERTa
    return layer.output.LayerNorm(x + layer.output.dense(h))


def roberta_apply(model: Roberta, input_ids: Tensor, attention_mask: Optional[Tensor] = None,
                  *, dtype=torch.float32) -> Tuple[Tensor, Tensor]:
    """``input_ids`` [B, S] (and ``attention_mask`` [B, S], 1 = real) →
    ``(last_hidden_state [B, S, D], pooler_output [B, D])``."""
    cfg = model.config
    if attention_mask is None:
        attention_mask = input_ids != cfg.pad_token_id
    mask = attention_mask.long()
    positions = torch.cumsum(mask, dim=1) * mask + cfg.pad_token_id

    emb = model.embeddings
    x = F.embedding(input_ids.long(), emb.word_embeddings.weight)
    x = x + F.embedding(positions, emb.position_embeddings.weight)
    x = x + emb.token_type_embeddings.weight[0][None, None]
    x = emb.LayerNorm(x).to(dtype)

    mask_bias = torch.where(mask.bool(), 0.0, NEG_INF).float()[:, None, None, :]
    for layer in model.encoder.layer:
        x = _block(x, layer, mask_bias, cfg.num_heads)
    return x, torch.tanh(model.pooler.dense(x[:, 0]))


# ---------------------------------------------------------------------------
# HF weights
# ---------------------------------------------------------------------------


def roberta_params_from_hf(state_dict, cfg: RobertaConfig, prefix: str = "") -> dict:
    """The JAX package's tree (numpy) of an HF ``RobertaModel`` state dict,
    optionally under a key prefix such as laion_clap's ``text_branch.``."""
    from clipcap_tpu_torch.convert import roberta_params

    model = Roberta(cfg)
    model.load_state_dict({k: state_dict[prefix + k].float() for k in model.state_dict()})
    return roberta_params(model)
