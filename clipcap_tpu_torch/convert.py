"""Parameter trees of the JAX package ⇄ the port's modules.

The JAX package keeps each model's weights as a nested dict with the layer
axis stacked first and ``[in, out]`` projection weights; its ``.npz``
checkpoints are that tree flattened (``train/checkpoint.py``).  The port's
modules use the original checkpoints' keys and layouts (HF GPT-2, the
reference mapper, OpenAI CLIP).  Each model has one table of rules,
``(state-dict key, tree path, layout)``, read in both directions: a key
with ``{i}`` is one layer of a stacked tree leaf; layout ``"T"`` transposes
a 2-D weight, ``"conv"`` turns the ``[3·p·p, D]`` patch matrix into the
``[D, 3, p, p]`` Conv2d weight.

The seeded ``init_*`` functions of the port return the same trees (numpy)
as the JAX package's, so ``*_from_params(init_*(cfg, seed))`` gives both
packages the same weights.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clipcap_tpu_torch.models.clip_vit import CLIP, CLIPConfig
from clipcap_tpu_torch.models.gpt2 import GPT2, GPT2Config
from clipcap_tpu_torch.models.mapper import MapperConfig, TransformerMapper

Rule = Tuple[str, str, Optional[str]]


def _ln(key: str, path: str) -> List[Rule]:
    return [(f"{key}.weight", f"{path}/scale", None), (f"{key}.bias", f"{path}/bias", None)]


def _lin(key: str, path: str, layout: Optional[str], bias: bool = True) -> List[Rule]:
    rules = [(f"{key}.weight", f"{path}/w", layout)]
    return rules + [(f"{key}.bias", f"{path}/b", None)] if bias else rules


GPT2_RULES: List[Rule] = [
    ("wte.weight", "wte", None), ("wpe.weight", "wpe", None),
    *_ln("h.{i}.ln_1", "h/ln_1"),
    *_lin("h.{i}.attn.c_attn", "h/attn/c_attn", None),     # HF Conv1D: [in, out]
    *_lin("h.{i}.attn.c_proj", "h/attn/c_proj", None),
    *_ln("h.{i}.ln_2", "h/ln_2"),
    *_lin("h.{i}.mlp.c_fc", "h/mlp/c_fc", None),
    *_lin("h.{i}.mlp.c_proj", "h/mlp/c_proj", None),
    *_ln("ln_f", "ln_f"),
]

MAPPER_RULES: List[Rule] = [
    *_lin("linear", "linear", "T"),
    ("prefix_const", "prefix_const", None),
    *_ln("transformer.layers.{i}.norm1", "layers/ln_1"),
    *_lin("transformer.layers.{i}.attn.to_queries", "layers/to_queries", "T", bias=False),
    *_lin("transformer.layers.{i}.attn.to_keys_values", "layers/to_keys_values", "T",
          bias=False),
    *_lin("transformer.layers.{i}.attn.project", "layers/project", "T"),
    *_ln("transformer.layers.{i}.norm2", "layers/ln_2"),
    *_lin("transformer.layers.{i}.mlp.fc1", "layers/fc1", "T"),
    *_lin("transformer.layers.{i}.mlp.fc2", "layers/fc2", "T"),
]


def _clip_blocks(key: str, path: str) -> List[Rule]:
    k, p = f"{key}.resblocks.{{i}}", f"{path}/blocks"
    return [
        *_ln(f"{k}.ln_1", f"{p}/ln_1"),
        (f"{k}.attn.in_proj_weight", f"{p}/attn/in_proj/w", "T"),
        (f"{k}.attn.in_proj_bias", f"{p}/attn/in_proj/b", None),
        *_lin(f"{k}.attn.out_proj", f"{p}/attn/out_proj", "T"),
        *_ln(f"{k}.ln_2", f"{p}/ln_2"),
        *_lin(f"{k}.mlp.c_fc", f"{p}/mlp/c_fc", "T"),
        *_lin(f"{k}.mlp.c_proj", f"{p}/mlp/c_proj", "T"),
    ]


CLIP_VISUAL_RULES: List[Rule] = [
    ("visual.conv1.weight", "visual/patch_embed/w", "conv"),
    ("visual.class_embedding", "visual/class_embedding", None),
    ("visual.positional_embedding", "visual/positional_embedding", None),
    *_ln("visual.ln_pre", "visual/ln_pre"),
    *_clip_blocks("visual.transformer", "visual"),
    *_ln("visual.ln_post", "visual/ln_post"),
    ("visual.proj", "visual/proj", None),
]

CLIP_TEXT_RULES: List[Rule] = [
    ("token_embedding.weight", "text/token_embedding", None),
    ("positional_embedding", "text/positional_embedding", None),
    *_clip_blocks("transformer", "text"),
    *_ln("ln_final", "text/ln_final"),
    ("text_projection", "text/text_projection", None),
    ("logit_scale", "logit_scale", None),
]


def _to_module(arr: np.ndarray, layout: Optional[str]) -> np.ndarray:
    if layout == "T":
        return arr.T
    if layout == "conv":
        D = arr.shape[1]
        p = int(round((arr.shape[0] // 3) ** 0.5))
        return arr.T.reshape(D, 3, p, p)
    return arr


def _to_tree(arr: np.ndarray, layout: Optional[str]) -> np.ndarray:
    if layout == "T":
        return arr.T
    if layout == "conv":
        return arr.reshape(arr.shape[0], -1).T
    return arr


def _get(tree: dict, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _set(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


Parts = List[Tuple[List[Rule], int]]  # (rules, layer count) per tower


def load_params(module: nn.Module, params: dict, parts: Parts) -> nn.Module:
    """Copy a parameter tree (numpy or array-likes) into ``module``; every
    weight of the module must be named by a rule."""
    sd: Dict[str, torch.Tensor] = {}
    for rules, layers in parts:
        for key, path, layout in rules:
            arr = np.asarray(_get(params, path), dtype=np.float32)
            for k, a in ([(key.format(i=i), arr[i]) for i in range(layers)]
                         if "{i}" in key else [(key, arr)]):
                sd[k] = torch.from_numpy(np.array(_to_module(a, layout), order="C"))
    module.load_state_dict(sd)
    return module


def module_params(module: nn.Module, parts: Parts) -> dict:
    """The parameter tree (numpy fp32) of ``module`` — the JAX layout."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in module.state_dict().items()}
    tree: dict = {}
    for rules, layers in parts:
        for key, path, layout in rules:
            if "{i}" in key:
                value = np.stack([_to_tree(sd[key.format(i=i)], layout)
                                  for i in range(layers)])
            else:
                value = _to_tree(sd[key], layout)
            _set(tree, path, np.array(value, order="C"))
    return tree


def _gpt2_parts(cfg: GPT2Config) -> Parts:
    return [(GPT2_RULES, cfg.n_layer)]


def _mapper_parts(cfg: MapperConfig) -> Parts:
    rules = MAPPER_RULES
    if cfg.windowed and cfg.use_pos_embeddings:
        rules = rules + [("pos_embeddings", "pos_embeddings", None)]
    return [(rules, cfg.num_layers)]


def _clip_parts(cfg: CLIPConfig) -> Parts:
    return [(CLIP_VISUAL_RULES, cfg.vision.layers), (CLIP_TEXT_RULES, cfg.text.layers)]


def gpt2_from_params(params: dict, cfg: GPT2Config) -> GPT2:
    return load_params(GPT2(cfg), params, _gpt2_parts(cfg))


def gpt2_params(model: GPT2) -> dict:
    return module_params(model, _gpt2_parts(model.config))


def mapper_from_params(params: dict, cfg: MapperConfig) -> TransformerMapper:
    return load_params(TransformerMapper(cfg), params, _mapper_parts(cfg))


def mapper_params(model: TransformerMapper) -> dict:
    return module_params(model, _mapper_parts(model.config))


def clip_from_params(params: dict, cfg: CLIPConfig) -> CLIP:
    """A :class:`CLIP` from the JAX tree ``{"visual", "text", "logit_scale"}``."""
    return load_params(CLIP(cfg), params, _clip_parts(cfg))
