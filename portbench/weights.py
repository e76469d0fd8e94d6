"""Seeded weights, made on the device in a few large calls.

Each model's weights are a dict under the published state-dict keys: HF
``GPT2Model`` for GPT-2, ClipCap's ``TransformerMapper`` for the mapper,
OpenAI's for the CLIP image tower.  The program loads the dict into its
modules (``load_state_dict(assign=True)``: no copy) and the reference
makes the same dict again from the same seed, so the two share no tensor.

Values: biases 0, norm scales 1, every other tensor N(0, 0.02) (CLIP's
``logit_scale`` is log(1/0.07)).  All the normal tensors of one model come
from one ``randn`` on a ``torch.Generator`` of the device, in the dtype
asked for, and are views into it.
"""
from __future__ import annotations

import math

import torch

STD = 0.02


def gpt2_shapes(c: dict) -> list:
    D, V, L = c["n_embd"], c["vocab_size"], c["n_layer"]
    out = [("wte.weight", (V, D)), ("wpe.weight", (c["n_positions"], D))]
    for i in range(L):
        p = f"h.{i}."
        out += [(p + "ln_1.weight", (D,)), (p + "ln_1.bias", (D,)),
                (p + "attn.c_attn.weight", (D, 3 * D)), (p + "attn.c_attn.bias", (3 * D,)),
                (p + "attn.c_proj.weight", (D, D)), (p + "attn.c_proj.bias", (D,)),
                (p + "ln_2.weight", (D,)), (p + "ln_2.bias", (D,)),
                (p + "mlp.c_fc.weight", (D, 4 * D)), (p + "mlp.c_fc.bias", (4 * D,)),
                (p + "mlp.c_proj.weight", (4 * D, D)), (p + "mlp.c_proj.bias", (D,))]
    return out + [("ln_f.weight", (D,)), ("ln_f.bias", (D,))]


def mapper_shapes(c: dict) -> list:
    D, E = c["lm_embedding_size"], c["encoder_embedding_size"]
    F = int(D * c["mlp_ratio"])
    out = [("linear.weight", (c["projection_length"] * D, E)),
           ("linear.bias", (c["projection_length"] * D,)),
           ("prefix_const", (c["prefix_length"], D))]
    for i in range(c["num_layers"]):
        p = f"transformer.layers.{i}."
        out += [(p + "norm1.weight", (D,)), (p + "norm1.bias", (D,)),
                (p + "attn.to_queries.weight", (D, D)),
                (p + "attn.to_keys_values.weight", (2 * D, D)),
                (p + "attn.project.weight", (D, D)), (p + "attn.project.bias", (D,)),
                (p + "norm2.weight", (D,)), (p + "norm2.bias", (D,)),
                (p + "mlp.fc1.weight", (F, D)), (p + "mlp.fc1.bias", (F,)),
                (p + "mlp.fc2.weight", (D, F)), (p + "mlp.fc2.bias", (D,))]
    return out


def clip_visual_shapes(c: dict) -> list:
    D, p, E = c["width"], c["patch_size"], c["embed_dim"]
    n = (c["image_size"] // p) ** 2 + 1
    out = [("visual.conv1.weight", (D, 3, p, p)), ("visual.class_embedding", (D,)),
           ("visual.positional_embedding", (n, D)),
           ("visual.ln_pre.weight", (D,)), ("visual.ln_pre.bias", (D,))]
    for i in range(c["layers"]):
        q = f"visual.transformer.resblocks.{i}."
        out += [(q + "ln_1.weight", (D,)), (q + "ln_1.bias", (D,)),
                (q + "attn.in_proj_weight", (3 * D, D)), (q + "attn.in_proj_bias", (3 * D,)),
                (q + "attn.out_proj.weight", (D, D)), (q + "attn.out_proj.bias", (D,)),
                (q + "ln_2.weight", (D,)), (q + "ln_2.bias", (D,)),
                (q + "mlp.c_fc.weight", (4 * D, D)), (q + "mlp.c_fc.bias", (4 * D,)),
                (q + "mlp.c_proj.weight", (D, 4 * D)), (q + "mlp.c_proj.bias", (D,))]
    return out + [("visual.ln_post.weight", (D,)), ("visual.ln_post.bias", (D,)),
                  ("visual.proj", (D, E))]


def _kind(name: str) -> str:
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "bias" or name.endswith("_bias"):
        return "zero"
    if leaf == "weight" and any(s in name for s in ("ln_", "norm")):
        return "one"
    return "normal"


def make(shapes: list, seed: int, device, dtype) -> dict:
    """The dict of ``shapes`` from ``seed``: one ``randn`` for the normal
    tensors, one ``zeros`` and one ``ones`` buffer for the rest."""
    sizes = {"normal": 0, "zero": 0, "one": 0}
    for name, shape in shapes:
        sizes[_kind(name)] += math.prod(shape)
    g = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    flat = {"normal": torch.randn(sizes["normal"], generator=g, device=device, dtype=dtype),
            "zero": torch.zeros(sizes["zero"], device=device, dtype=dtype),
            "one": torch.ones(sizes["one"], device=device, dtype=dtype)}
    flat["normal"].mul_(STD)
    at = {k: 0 for k in sizes}
    out = {}
    for name, shape in shapes:
        k, n = _kind(name), math.prod(shape)
        out[name] = flat[k][at[k]:at[k] + n].view(shape)
        at[k] += n
    return out


def sub_seed(seed: int, what: str) -> int:
    """A seed per purpose (weights of each model, inputs), from ``--seed``."""
    h = 1469598103934665603
    for ch in f"{seed}:{what}".encode():
        h = ((h ^ ch) * 1099511628211) % 2 ** 64
    return h % 2 ** 63


def gpt2(cfg: dict, seed: int, device, dtype) -> dict:
    return make(gpt2_shapes(cfg["language_model"]), sub_seed(seed, "gpt2"), device, dtype)


def mapper(cfg: dict, seed: int, device, dtype) -> dict:
    return make(mapper_shapes(cfg["mapper"]), sub_seed(seed, "mapper"), device, dtype)


def clip_visual(cfg: dict, seed: int, device, dtype) -> dict:
    out = make(clip_visual_shapes(cfg["encoder"]), sub_seed(seed, "clip"), device, dtype)
    out["logit_scale"] = torch.tensor(math.log(1 / 0.07), device=device, dtype=dtype)
    return out
