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

A weight leaf may also be the JAX package's int8 form ``{"q", "s"}``
(``ops/quant.py``): it maps to an ``Int8Weight`` in place of the module's
weight, under the keys ``<weight>.q`` (int8, the module's layout) and
``<weight>.s`` (fp32), so a tree quantised by either package loads into the
port's quantised modules and reads back out of them.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from clipcap_tpu_torch.models.clip_vit import CLIP, CLIPConfig
from clipcap_tpu_torch.models.gpt2 import GPT2, GPT2Config
from clipcap_tpu_torch.models.mapper import MapperConfig, TransformerMapper
from clipcap_tpu_torch.ops.layers import Int8Weight

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


def _is_int8(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def _leaves(params: dict, layers: int, key: str, path: str, layout: Optional[str]):
    """The state-dict entries of one rule: ``(key, numpy array)`` pairs in
    the module's layout, one per layer for a stacked key."""
    leaf = _get(params, path)
    if _is_int8(leaf):
        fields = [(f"{key}.q", np.asarray(leaf["q"], np.int8), layout),
                  (f"{key}.s", np.asarray(leaf["s"], np.float32), None)]
    else:
        fields = [(key, np.asarray(leaf, np.float32), layout)]
    for k, arr, lay in fields:
        for name, a in ([(k.format(i=i), arr[i]) for i in range(layers)]
                        if "{i}" in k else [(k, arr)]):
            yield name, np.array(_to_module(a, lay), order="C")


def state_dict_from_tree(params: dict, parts: Parts) -> Dict[str, torch.Tensor]:
    """A parameter tree (numpy or array-likes, the JAX layout) as a state
    dict of CPU tensors in the modules' layout: fp32, and int8 for the
    ``q`` of an int8 leaf."""
    return {k: torch.from_numpy(a) for rules, layers in parts for rule in rules
            for k, a in _leaves(params, layers, *rule)}


def tree_from_state_dict(sd: Mapping[str, torch.Tensor], parts: Parts) -> dict:
    """A state dict in the modules' layout as a parameter tree (numpy
    fp32, the JAX layout; int8 weights as ``{"q", "s"}`` leaves).  Reads
    parameters and anything shaped like them (the optimizer's moments)."""
    sd = {k: (v.float() if v.is_floating_point() else v).detach().cpu().numpy()
          for k, v in sd.items()}

    def value(key, layout, layers):
        if "{i}" in key:
            return np.stack([_to_tree(sd[key.format(i=i)], layout) for i in range(layers)])
        return _to_tree(sd[key], layout)

    tree: dict = {}
    for rules, layers in parts:
        for key, path, layout in rules:
            if f"{key.format(i=0)}.q" in sd:
                leaf = {"q": np.array(value(f"{key}.q", layout, layers), order="C"),
                        "s": np.array(value(f"{key}.s", None, layers), np.float32)}
            else:
                leaf = np.array(value(key, layout, layers), np.float32, order="C")
            _set(tree, path, leaf)
    return tree


def load_params(module: nn.Module, params: dict, parts: Parts) -> nn.Module:
    """Copy a parameter tree into ``module``; every weight of the module
    must be named by a rule.  An int8 leaf replaces the module's float
    weight by an ``Int8Weight``."""
    sd = state_dict_from_tree(params, parts)
    for rules, layers in parts:
        for key, path, layout in rules:
            if _is_int8(_get(params, path)):
                for k in ([key.format(i=i) for i in range(layers)] if "{i}" in key else [key]):
                    owner, _, name = k.rpartition(".")
                    target = module.get_submodule(owner)
                    delattr(target, name)
                    setattr(target, name, Int8Weight(sd[f"{k}.q"], sd[f"{k}.s"],
                                                     out_in=layout == "T"))
    module.load_state_dict(sd)
    return module


def module_params(module: nn.Module, parts: Parts) -> dict:
    """The parameter tree (numpy fp32) of ``module`` — the JAX layout."""
    return tree_from_state_dict(module.state_dict(), parts)


def _gpt2_parts(cfg: GPT2Config) -> Parts:
    return [(GPT2_RULES, cfg.n_layer)]


def _mapper_parts(cfg: MapperConfig) -> Parts:
    rules = MAPPER_RULES
    if cfg.windowed and cfg.use_pos_embeddings:
        rules = rules + [("pos_embeddings", "pos_embeddings", None)]
    return [(rules, cfg.num_layers)]


def _clip_parts(cfg: CLIPConfig) -> Parts:
    return [(CLIP_VISUAL_RULES, cfg.vision.layers), (CLIP_TEXT_RULES, cfg.text.layers)]


def _clipcap_parts(model) -> Dict[str, tuple]:
    """Each subtree of the ClipCap parameter tree ``{"mapper", "lm"}``: the
    name prefix of its weights in ``ClipCapModel`` and its rules."""
    return {"mapper": ("transformer_mapper.", _mapper_parts(model.mapper_config)),
            "lm": ("language_model.", _gpt2_parts(model.lm_config))}


def clipcap_tree(model, named: Mapping[str, torch.Tensor]) -> dict:
    """Tensors named as ``model``'s parameters (the parameters themselves,
    their grads or their moments) → the JAX tree ``{"mapper", "lm"}``,
    with only the subtrees that ``named`` covers."""
    tree = {}
    for sub, (prefix, parts) in _clipcap_parts(model).items():
        sd = {k[len(prefix):]: v for k, v in named.items() if k.startswith(prefix)}
        if sd:
            tree[sub] = tree_from_state_dict(sd, parts)
    return tree


def clipcap_named(model, tree: dict) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`clipcap_tree`: fp32 CPU tensors by parameter
    name, for the subtrees ``tree`` has."""
    named = {}
    for sub, (prefix, parts) in _clipcap_parts(model).items():
        if sub in tree:
            sd = state_dict_from_tree(tree[sub], parts)
            named.update({prefix + k: v for k, v in sd.items()})
    return named


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
