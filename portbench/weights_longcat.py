"""Seeded LongCat-Flash weights for the benchmark, made on the device.

The port's keys (``models/longcat_flash.py``): the published ones, each
double layer's ``self_attn.{0,1}`` (query LoRA, latent projections),
``mlps.{0,1}``, ``input_layernorm.{0,1}``, ``post_attention_layernorm.{0,1}``,
the router ``mlp.router.classifier.weight`` and
``mlp.router.e_score_correction_bias`` over all FFN and identity experts,
and the held FFN experts stacked (``mlp.experts.gate_up_proj`` [E_held,
2F, D], gate | up, and ``mlp.experts.down_proj`` [E_held, D, F]); the
untied head.  Matrices come from one ``randn`` as ``weights.make`` gives
every model (N(0, 0.02), norm scales 1); the selection bias from a
generator of its own, N(0, ``selection_bias_std``).  ``cfg`` is the
configuration file: the model's ``config.json`` keys at the top level,
``n_routed_experts`` the FFN experts held here (``experts_held`` of
``n_routed_experts_published``).
"""
from __future__ import annotations

import torch

from portbench import weights

BIAS = "mlp.router.e_score_correction_bias"


def shapes(c: dict) -> list:
    D, V, H = c["hidden_size"], c["vocab_size"], c["num_attention_heads"]
    ql, C, r = c["q_lora_rank"], c["kv_lora_rank"], c["qk_rope_head_dim"]
    nope, vd = c["qk_nope_head_dim"], c["v_head_dim"]
    Fd, Fe, E = c["ffn_hidden_size"], c["expert_ffn_hidden_size"], c["n_routed_experts"]
    width = c["n_routed_experts_published"] + c["zero_expert_num"]
    out = [("model.embed_tokens.weight", (V, D))]
    for i in range(c["num_layers"]):
        p = f"model.layers.{i}."
        for h in (0, 1):
            a = f"{p}self_attn.{h}."
            out += [(a + "q_a_proj.weight", (ql, D)), (a + "q_a_layernorm.weight", (ql,)),
                    (a + "q_b_proj.weight", (H * (nope + r), ql)),
                    (a + "kv_a_proj_with_mqa.weight", (C + r, D)),
                    (a + "kv_a_layernorm.weight", (C,)),
                    (a + "kv_b_proj.weight", (H * (nope + vd), C)),
                    (a + "o_proj.weight", (D, H * vd)),
                    (f"{p}mlps.{h}.gate_proj.weight", (Fd, D)),
                    (f"{p}mlps.{h}.up_proj.weight", (Fd, D)),
                    (f"{p}mlps.{h}.down_proj.weight", (D, Fd)),
                    (f"{p}input_layernorm.{h}.weight", (D,)),
                    (f"{p}post_attention_layernorm.{h}.weight", (D,))]
        out += [(p + "mlp.router.classifier.weight", (width, D)), (p + BIAS, (width,)),
                (p + "mlp.experts.gate_up_proj", (E, 2 * Fe, D)),
                (p + "mlp.experts.down_proj", (E, D, Fe))]
    return out + [("model.norm.weight", (D,)), ("lm_head.weight", (V, D))]


def longcat(cfg: dict, seed: int, device, dtype) -> dict:
    every = shapes(cfg)
    out = weights.make([e for e in every if not e[0].endswith(BIAS)],
                       weights.sub_seed(seed, "longcat"), device, dtype)
    g = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, "longcat:bias"))
    for name, shape in every:
        if name.endswith(BIAS):
            t = torch.randn(shape, generator=g, device=device) * cfg["selection_bias_std"]
            out[name] = t.to(dtype)
    return out
