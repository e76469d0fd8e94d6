"""Mapping networks: encoder embedding → LM prefix embeddings.

Counterpart of ``clipcap_tpu/models/mapper.py``: the reference's
``TransformerMapper`` and ``TransformerMapperWindowed``.  Weights sit
under the reference's state-dict keys (``linear``, ``prefix_const``,
``transformer.layers.{i}.norm1`` / ``attn.to_queries`` / ``attn.to_keys_values``
/ ``attn.project`` / ``norm2`` / ``mlp.fc1`` / ``mlp.fc2``, optional
``pos_embeddings``), so ``clipcap_tpu.models.mapper.mapper_params_from_torch``
reads the state dict.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from clipcap_tpu_torch.ops.layers import (LayerNorm, Linear, empty_param, normal_init,
                                          ones_init, relu, torch_linear_init, zeros_init)

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    encoder_embedding_size: int
    lm_embedding_size: int
    prefix_length: int = 10
    projection_length: int = 10
    num_heads: int = 8
    num_layers: int = 8
    mlp_ratio: float = 2.0
    # Windowed variant: window_size = encoder window_size + 1 (global + tiles).
    window_size: Optional[int] = None
    use_pos_embeddings: bool = False
    layer_norm_epsilon: float = 1e-5

    @property
    def windowed(self) -> bool:
        return self.window_size is not None

    @property
    def n_proj_tokens(self) -> int:
        """Tokens produced by the projection (before the learned prefix)."""
        if self.windowed:
            return self.window_size * self.projection_length
        return self.projection_length

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def init_mapper(cfg: MapperConfig, seed: int = 0) -> dict:
    """Seeded weights as the JAX package's parameter tree (numpy, layer-
    stacked, ``[in, out]`` weights): the same draws as
    ``clipcap_tpu.models.mapper.init_mapper``."""
    rng = np.random.default_rng(seed)
    L, D = cfg.num_layers, cfg.lm_embedding_size
    F = int(D * cfg.mlp_ratio)

    def stack_linear(in_dim, out_dim, bias=True):
        ws, bs = zip(*(torch_linear_init(rng, in_dim, out_dim) for _ in range(L)))
        out = {"w": np.stack(ws)}
        if bias:
            out["b"] = np.stack(bs)
        return out

    lw, lb = torch_linear_init(rng, cfg.encoder_embedding_size, cfg.projection_length * D)
    params = {
        "linear": {"w": lw, "b": lb},
        "prefix_const": normal_init(rng, (cfg.prefix_length, D), std=1.0),
        "layers": {
            "ln_1": {"scale": ones_init((L, D)), "bias": zeros_init((L, D))},
            "to_queries": {"w": stack_linear(D, D, bias=False)["w"]},
            "to_keys_values": {"w": stack_linear(D, 2 * D, bias=False)["w"]},
            "project": stack_linear(D, D, bias=True),
            "ln_2": {"scale": ones_init((L, D)), "bias": zeros_init((L, D))},
            "fc1": stack_linear(D, F, bias=True),
            "fc2": stack_linear(F, D, bias=True),
        },
    }
    if cfg.windowed and cfg.use_pos_embeddings:
        params["pos_embeddings"] = normal_init(rng, (cfg.n_proj_tokens, D), std=1.0)
    return params


class _MultiHeadAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.to_queries = Linear(d, d, bias=False)
        self.to_keys_values = Linear(d, 2 * d, bias=False)
        self.project = Linear(d, d)


class _MLP(nn.Module):
    def __init__(self, d: int, f: int):
        super().__init__()
        self.fc1 = Linear(d, f)
        self.fc2 = Linear(f, d)


class _Layer(nn.Module):
    def __init__(self, cfg: MapperConfig):
        super().__init__()
        d, eps = cfg.lm_embedding_size, cfg.layer_norm_epsilon
        self.norm1 = LayerNorm(d, eps)
        self.attn = _MultiHeadAttention(d)
        self.norm2 = LayerNorm(d, eps)
        self.mlp = _MLP(d, int(d * cfg.mlp_ratio))


class _Transformer(nn.Module):
    def __init__(self, cfg: MapperConfig):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(cfg) for _ in range(cfg.num_layers))


def _mapper_block(x: Tensor, layer: _Layer, cfg: MapperConfig) -> Tensor:
    """Pre-norm transformer layer with fused-KV attention and a ReLU MLP."""
    B, N, D = x.shape
    H = cfg.num_heads
    Dh = D // H
    h = layer.norm1(x)
    q = layer.attn.to_queries(h).reshape(B, N, H, Dh)
    kv = layer.attn.to_keys_values(h).reshape(B, N, 2, H, Dh)
    k, v = kv[:, :, 0], kv[:, :, 1]
    logits = torch.einsum("bnhd,bmhd->bnmh", q, k) * Dh ** -0.5
    w = torch.softmax(logits.float(), dim=2).to(x.dtype)
    attn = torch.einsum("bnmh,bmhd->bnhd", w, v).reshape(B, N, D)
    x = x + layer.attn.project(attn)
    h = layer.mlp.fc2(relu(layer.mlp.fc1(layer.norm2(x))))
    return x + h


class TransformerMapper(nn.Module):
    """The plain and the windowed mapper (``cfg.window_size``).  Calling it
    maps ``[B, E]`` (plain) or ``[B, W, E]`` (windowed) embeddings to
    ``[B, prefix_length, lm_dim]`` prefix embeddings."""

    def __init__(self, cfg: MapperConfig):
        super().__init__()
        self.config = cfg
        D = cfg.lm_embedding_size
        self.linear = Linear(cfg.encoder_embedding_size, cfg.projection_length * D)
        self.prefix_const = empty_param(cfg.prefix_length, D)
        self.transformer = _Transformer(cfg)
        if cfg.windowed and cfg.use_pos_embeddings:
            self.pos_embeddings = empty_param(cfg.n_proj_tokens, D)
        else:
            self.pos_embeddings = None

    def forward(self, embedding, dtype=torch.float32) -> Tensor:
        return mapper_apply(self, embedding, dtype=dtype)


def mapper_apply(mapper: TransformerMapper, embedding, *, dtype=torch.float32) -> Tensor:
    """Map encoder embeddings (array or tensor; moved to the mapper's
    device) to ``[B, prefix_length, lm_dim]`` prefix embeddings."""
    cfg = mapper.config
    D = cfg.lm_embedding_size
    emb = torch.as_tensor(embedding, device=mapper.prefix_const.device).to(dtype)
    B = emb.shape[0]
    # The windowed projection applies the same linear to each window;
    # windows are contiguous in the flattened token axis.
    x = mapper.linear(emb).reshape(B, cfg.n_proj_tokens, D)
    if mapper.pos_embeddings is not None:
        x = x + mapper.pos_embeddings.to(dtype)[None]
    prefix = mapper.prefix_const.to(dtype)[None].expand(B, -1, -1)
    x = torch.cat([x, prefix], dim=1)
    for layer in mapper.transformer.layers:
        x = _mapper_block(x, layer, cfg)
    return x[:, cfg.n_proj_tokens:]
