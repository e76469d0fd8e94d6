"""Parameter trees of the JAX package ⇄ the port's modules.

The JAX package keeps each model's weights as a nested dict with the layer
axis stacked first and ``[in, out]`` projection weights; its ``.npz``
checkpoints are that tree flattened (``train/checkpoint.py``).  The port's
modules use the original checkpoints' keys and layouts (HF GPT-2, the
reference mapper, OpenAI CLIP, laion_clap's HTSAT and RoBERTa).  Each model
has one table of rules, ``(state-dict key, tree path, layout)``, read in
both directions: a key with ``{i}`` is one layer of a stacked tree leaf, a
number in a path an index into a list of the tree; layout ``"T"``
transposes a 2-D weight, and the conv layouts turn a flattened patch matrix
``[C·kh·kw, D]`` into the ``[D, C, kh, kw]`` Conv2d weight: ``"conv"`` the
ViT's (C = 3, p×p), ``"conv1"`` HTSAT's (C = 1, p×p), ``"conv1x3"`` its
``mel_conv2d`` (C = 1, p×3p), ``"1x1"`` a 1×1 conv.

The ResNet towers keep four tensors per batch norm where the JAX tree keeps
the folded ``scale``/``bias`` pair, so they convert by hand
(:func:`resnet_from_params`, :func:`resnet_params`).

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

from clipcap_tpu_torch.models.clip_resnet import CLIPResNetConfig, ModifiedResNet, stack_trees
from clipcap_tpu_torch.models.clip_vit import CLIP, CLIPConfig, is_resnet_config
from clipcap_tpu_torch.models.gpt2 import GPT2, GPT2Config
from clipcap_tpu_torch.models.htsat import CLAPAudio, CLAPText, HTSATConfig
from clipcap_tpu_torch.models.mapper import MapperConfig, TransformerMapper
from clipcap_tpu_torch.models.roberta import Roberta, RobertaConfig
from clipcap_tpu_torch.ops.layers import BatchNorm, Int8Weight

Rule = Tuple[str, str, Optional[str]]


def _ln(key: str, path: str) -> List[Rule]:
    return [(f"{key}.weight", f"{path}/scale", None), (f"{key}.bias", f"{path}/bias", None)]


def _lin(key: str, path: str, layout: Optional[str], bias: bool = True) -> List[Rule]:
    rules = [(f"{key}.weight", f"{path}/w", layout)]
    return rules + [(f"{key}.bias", f"{path}/b", None)] if bias else rules


def _bn(key: str, path: str) -> List[Rule]:
    return [(f"{key}.{k}", f"{path}/{p}", None) for k, p in
            (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
             ("running_var", "var"))]


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


ROBERTA_RULES: List[Rule] = [
    ("embeddings.word_embeddings.weight", "word_embeddings", None),
    ("embeddings.position_embeddings.weight", "position_embeddings", None),
    ("embeddings.token_type_embeddings.weight", "token_type_embeddings", None),
    *_ln("embeddings.LayerNorm", "emb_ln"),
    *_lin("encoder.layer.{i}.attention.self.query", "layers/q", "T"),
    *_lin("encoder.layer.{i}.attention.self.key", "layers/k", "T"),
    *_lin("encoder.layer.{i}.attention.self.value", "layers/v", "T"),
    *_lin("encoder.layer.{i}.attention.output.dense", "layers/attn_out", "T"),
    *_ln("encoder.layer.{i}.attention.output.LayerNorm", "layers/attn_ln"),
    *_lin("encoder.layer.{i}.intermediate.dense", "layers/fc1", "T"),
    *_lin("encoder.layer.{i}.output.dense", "layers/fc2", "T"),
    *_ln("encoder.layer.{i}.output.LayerNorm", "layers/out_ln"),
    *_lin("pooler.dense", "pooler", "T"),
]

CLAP_TEXT_RULES: List[Rule] = [
    *[("text_branch." + key, "roberta/" + path, layout) for key, path, layout in ROBERTA_RULES],
    *_lin("text_projection.0", "projection/fc1", "T"),
    *_lin("text_projection.2", "projection/fc2", "T"),
]


def _htsat_rules(cfg: HTSATConfig) -> List[Rule]:
    A = "audio_branch."
    rules = [
        *_bn(A + "bn0", "bn0"),
        *_lin(A + "patch_embed.proj", "patch_embed/proj", "conv1"),
        *_ln(A + "patch_embed.norm", "patch_embed/norm"),
        *_ln(A + "norm", "norm"),
        *_lin("audio_projection.0", "audio_projection/fc1", "T"),
        *_lin("audio_projection.2", "audio_projection/fc2", "T"),
    ]
    if cfg.enable_fusion:
        rules += _lin(A + "patch_embed.mel_conv2d", "patch_embed/mel_conv2d", "conv1x3")
        # AFF's Sequentials: local_att [Conv, BN, ReLU, Conv, BN], global_att
        # [AvgPool, Conv, BN, ReLU, Conv, BN].
        for branch, (c1, b1, c2, b2) in (("local", "0134"), ("global", "1245")):
            k, p = f"{A}patch_embed.fusion_model.{branch}_att", f"patch_embed/fusion/{branch}"
            rules += [*_lin(f"{k}.{c1}", f"{p}/conv1", "1x1"), *_bn(f"{k}.{b1}", f"{p}/bn1"),
                      *_lin(f"{k}.{c2}", f"{p}/conv2", "1x1"), *_bn(f"{k}.{b2}", f"{p}/bn2")]
    for s, depth in enumerate(cfg.depths):
        for j in range(depth):
            k, p = f"{A}layers.{s}.blocks.{j}", f"stages/{s}/blocks/{j}"
            rules += [
                *_ln(f"{k}.norm1", f"{p}/norm1"),
                *_lin(f"{k}.attn.qkv", f"{p}/attn/qkv", "T"),
                *_lin(f"{k}.attn.proj", f"{p}/attn/proj", "T"),
                (f"{k}.attn.relative_position_bias_table", f"{p}/attn/rel_bias", None),
                *_ln(f"{k}.norm2", f"{p}/norm2"),
                *_lin(f"{k}.mlp.fc1", f"{p}/mlp/fc1", "T"),
                *_lin(f"{k}.mlp.fc2", f"{p}/mlp/fc2", "T"),
            ]
        if s < len(cfg.depths) - 1:
            k, p = f"{A}layers.{s}.downsample", f"stages/{s}/downsample"
            rules += [*_ln(f"{k}.norm", f"{p}/norm"),
                      *_lin(f"{k}.reduction", f"{p}/reduction", "T", bias=False)]
    return rules


# Conv layouts: the [in channels, kh, kw] of the flattened patch matrix's
# rows, from its row count n.
_CONV_SHAPES = {
    "conv": lambda n: (3, round((n // 3) ** 0.5), round((n // 3) ** 0.5)),
    "conv1": lambda n: (1, round(n ** 0.5), round(n ** 0.5)),
    "conv1x3": lambda n: (1, round((n // 3) ** 0.5), 3 * round((n // 3) ** 0.5)),
    "1x1": lambda n: (n, 1, 1),
}


def _to_module(arr: np.ndarray, layout: Optional[str]) -> np.ndarray:
    if layout == "T":
        return arr.T
    if layout in _CONV_SHAPES:
        return arr.T.reshape(arr.shape[1], *_CONV_SHAPES[layout](arr.shape[0]))
    return arr


def _to_tree(arr: np.ndarray, layout: Optional[str]) -> np.ndarray:
    if layout == "T":
        return arr.T
    if layout in _CONV_SHAPES:
        return arr.reshape(arr.shape[0], -1).T
    return arr


def _get(tree, path: str):
    for part in path.split("/"):
        tree = tree[int(part)] if isinstance(tree, list) else tree[part]
    return tree


def _set(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for part in parents:
        tree = tree.setdefault(part, {})
    tree[leaf] = value


def _listify(tree):
    """Dicts keyed ``"0"``, ``"1"``, … (numbers in rule paths) → lists."""
    if not isinstance(tree, dict):
        return tree
    out = {k: _listify(v) for k, v in tree.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


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
    return _listify(tree)


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
    if is_resnet_config(cfg.vision):
        model = CLIP(cfg)
        sd = state_dict_from_tree(params, [(CLIP_TEXT_RULES, cfg.text.layers)])
        sd.update({"visual." + k: v
                   for k, v in resnet_state_dict(params["visual"], cfg.vision).items()})
        model.load_state_dict(sd)
        _fold_identity(model.visual)
        return model
    return load_params(CLIP(cfg), params, _clip_parts(cfg))


# ---------------------------------------------------------------------------
# ResNet towers: HWIO convs and folded batch norms in the tree
# ---------------------------------------------------------------------------


def _hwio(w) -> torch.Tensor:
    """[kh, kw, in, out] → Conv2d's [out, in, kh, kw]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(w, np.float32).transpose(3, 2, 0, 1)))


def _resnet_block_sd(p: dict, key: str) -> Dict[str, torch.Tensor]:
    convs = [("conv1", "conv1", "bn1", "bn1"), ("conv2", "conv2", "bn2", "bn2"),
             ("conv3", "conv3", "bn3", "bn3")]
    if "downsample" in p:
        convs.append(("downsample/conv", "downsample.0", "downsample/bn", "downsample.1"))
    sd = {}
    for conv, conv_key, bn, bn_key in convs:
        sd[f"{key}.{conv_key}.weight"] = _hwio(_get(p, conv)["w"])
        scale, bias = (np.asarray(_get(p, bn)[k], np.float32) for k in ("scale", "bias"))
        sd[f"{key}.{bn_key}.weight"] = torch.from_numpy(scale.copy())
        sd[f"{key}.{bn_key}.bias"] = torch.from_numpy(bias.copy())
        sd[f"{key}.{bn_key}.running_mean"] = torch.zeros(len(scale))
        sd[f"{key}.{bn_key}.running_var"] = torch.ones(len(scale))
    return sd


def resnet_state_dict(params: dict, cfg: CLIPResNetConfig) -> Dict[str, torch.Tensor]:
    """The ResNet tree (``init_clip_resnet``'s) as a :class:`ModifiedResNet`
    state dict: each folded ``scale``/``bias`` as ``weight``/``bias`` over a
    zero mean and unit variance, for a module whose norms have ``eps = 0``
    (:func:`resnet_from_params`), so ``x·scale + bias`` is exact."""
    sd = _resnet_block_sd(params["stem"], "")
    sd = {k[1:]: v for k, v in sd.items()}                     # the stem has no prefix
    for s, stage in enumerate(params["stages"]):
        sd.update(_resnet_block_sd(stage["block0"], f"layer{s + 1}.0"))
        for i in range(cfg.layers[s] - 1):
            block = _index(stage["tail"], i)
            sd.update(_resnet_block_sd(block, f"layer{s + 1}.{i + 1}"))
    pool = params["attnpool"]
    sd["attnpool.positional_embedding"] = torch.from_numpy(
        np.array(pool["positional_embedding"], np.float32))
    for name in ("q_proj", "k_proj", "v_proj", "c_proj"):
        sd[f"attnpool.{name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.asarray(pool[name]["w"], np.float32).T))
        sd[f"attnpool.{name}.bias"] = torch.from_numpy(np.array(pool[name]["b"], np.float32))
    return sd


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _fold_identity(model: nn.Module) -> None:
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.eps = 0.0


def resnet_from_params(params: dict, cfg: CLIPResNetConfig) -> ModifiedResNet:
    """A :class:`ModifiedResNet` from the JAX tree; its batch norms compute
    the tree's ``x·scale + bias`` exactly (``eps = 0`` over unit variance),
    not through a round trip ``running_var = 1 - eps``."""
    model = ModifiedResNet(cfg)
    model.load_state_dict(resnet_state_dict(params, cfg))
    _fold_identity(model)
    return model


def _resnet_block_tree(block) -> dict:
    def conv(c):
        return {"w": np.ascontiguousarray(c.weight.detach().float().cpu().numpy()
                                          .transpose(2, 3, 1, 0))}

    def bn(b: BatchNorm):
        scale, shift = b.folded()
        return {"scale": scale.cpu().numpy(), "bias": shift.cpu().numpy()}

    p = {"conv1": conv(block.conv1), "bn1": bn(block.bn1), "conv2": conv(block.conv2),
         "bn2": bn(block.bn2), "conv3": conv(block.conv3), "bn3": bn(block.bn3)}
    if hasattr(block, "downsample"):
        p["downsample"] = {"conv": conv(block.downsample["0"]), "bn": bn(block.downsample["1"])}
    return p


def resnet_params(model: ModifiedResNet) -> dict:
    """The JAX tree (numpy fp32) of a :class:`ModifiedResNet`: HWIO convs,
    each batch norm folded in fp64 as the JAX importer folds it."""
    stages = []
    for blocks in model.stages():
        tail = [_resnet_block_tree(b) for b in blocks[1:]]
        stages.append({"block0": _resnet_block_tree(blocks[0]),
                       "tail": stack_trees(tail) if tail else None})
    pool = model.attnpool

    def lin(m):
        return {"w": m.weight.detach().float().cpu().numpy().T.copy(),
                "b": m.bias.detach().float().cpu().numpy()}

    return {
        "stem": _resnet_block_tree(model),
        "stages": stages,
        "attnpool": {"positional_embedding": pool.positional_embedding.detach().float()
                     .cpu().numpy(),
                     "q_proj": lin(pool.q_proj), "k_proj": lin(pool.k_proj),
                     "v_proj": lin(pool.v_proj), "c_proj": lin(pool.c_proj)},
    }


# ---------------------------------------------------------------------------
# CLAP: HTSAT (audio half) and RoBERTa + projection (text half)
# ---------------------------------------------------------------------------


def htsat_from_params(params: dict, cfg: HTSATConfig) -> CLAPAudio:
    """A :class:`CLAPAudio` from ``init_htsat``'s tree (fusion tensors
    included where ``cfg.enable_fusion``)."""
    return load_params(CLAPAudio(cfg), params, [(_htsat_rules(cfg), 1)])


def htsat_params(model: CLAPAudio) -> dict:
    return module_params(model, [(_htsat_rules(model.config), 1)])


def roberta_params(model: Roberta) -> dict:
    return module_params(model, [(ROBERTA_RULES, model.config.num_layers)])


def clap_text_from_params(text_params: dict, cfg: RobertaConfig) -> CLAPText:
    """A :class:`CLAPText` from the JAX text tree ``{"roberta", "projection"}``."""
    embed_dim = np.shape(text_params["projection"]["fc1"]["w"])[1]
    return load_params(CLAPText(cfg, embed_dim), text_params, [(CLAP_TEXT_RULES, cfg.num_layers)])


def clap_text_params(model: CLAPText) -> dict:
    return module_params(model, [(CLAP_TEXT_RULES, model.config.num_layers)])
