"""Seeded Kimi-Linear weights for the benchmark, made on the device.

The port's keys (``models/kimi_linear.py``), the held experts stacked
(``mlp.experts.gate_up_proj`` [E_held, 2F, D], gate | up, and
``mlp.experts.down_proj`` [E_held, D, F]).  Matrices and convolution taps
come from one ``randn`` as ``weights.make`` gives every model (N(0, 0.02),
norm scales 1, the output gate's bias 0); the KDA decay's ``A_log`` (ln
U(1, 16)) and ``dt_bias`` (softplus⁻¹ of a log-uniform step in [0.001,
0.1]), flash-linear-attention's initialisation, and the router's selection
bias (N(0, 0.02)) from a generator of their own.  ``cfg`` is the
configuration file: the model's ``config.json`` keys at the top level,
``num_experts`` the experts held here (``experts_held``).
"""
from __future__ import annotations

import torch

from clipcap_tpu_torch.models.kimi_linear import inverse_softplus_dt

from portbench import weights

SPECIAL = ("A_log", "dt_bias", "e_score_correction_bias")


def shapes(c: dict) -> list:
    D, V, H = c["hidden_size"], c["vocab_size"], c["num_attention_heads"]
    nope, r, vd, C = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                      c["kv_lora_rank"])
    la = c["linear_attn_config"]
    Hk, d, T = la["num_heads"], la["head_dim"], la["short_conv_kernel_size"]
    HD = Hk * d
    E, Fm = c["num_experts"], c["moe_intermediate_size"]
    out = [("model.embed_tokens.weight", (V, D))]
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        a = p + "self_attn."
        out += [(p + "input_layernorm.weight", (D,))]
        if i + 1 in la["kda_layers"]:
            out += [(a + f"{n}_proj.weight", (HD, D)) for n in "qkv"]
            out += [(a + f"{n}_conv1d.weight", (HD, 1, T)) for n in "qkv"]
            out += [(a + "A_log", (Hk,)), (a + "f_a_proj.weight", (d, D)),
                    (a + "f_b_proj.weight", (HD, d)), (a + "dt_bias", (HD,)),
                    (a + "b_proj.weight", (Hk, D)), (a + "g_a_proj.weight", (d, D)),
                    (a + "g_b_proj.weight", (HD, d)), (a + "g_b_proj.bias", (HD,)),
                    (a + "o_norm.weight", (d,)), (a + "o_proj.weight", (D, HD))]
        else:
            out += [(a + "q_proj.weight", (H * (nope + r), D)),
                    (a + "kv_a_proj_with_mqa.weight", (C + r, D)),
                    (a + "kv_a_layernorm.weight", (C,)),
                    (a + "kv_b_proj.weight", (H * (nope + vd), C)),
                    (a + "o_proj.weight", (D, H * vd))]
        out += [(p + "post_attention_layernorm.weight", (D,))]
        if i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0:
            Fs = Fm * c["num_shared_experts"]
            out += [(p + "mlp.gate.weight", (c["num_experts_published"], D)),
                    (p + "mlp.gate.e_score_correction_bias", (c["num_experts_published"],)),
                    (p + "mlp.experts.gate_up_proj", (E, 2 * Fm, D)),
                    (p + "mlp.experts.down_proj", (E, D, Fm)),
                    (p + "mlp.shared_experts.gate_proj.weight", (Fs, D)),
                    (p + "mlp.shared_experts.up_proj.weight", (Fs, D)),
                    (p + "mlp.shared_experts.down_proj.weight", (D, Fs))]
        else:
            Fd = c["intermediate_size"]
            out += [(p + "mlp.gate_proj.weight", (Fd, D)), (p + "mlp.up_proj.weight", (Fd, D)),
                    (p + "mlp.down_proj.weight", (D, Fd))]
    return out + [("model.norm.weight", (D,)), ("lm_head.weight", (V, D))]


def kimi(cfg: dict, seed: int, device, dtype) -> dict:
    every = shapes(cfg)
    special = [(n, s) for n, s in every if n.rsplit(".", 1)[-1] in SPECIAL]
    out = weights.make([e for e in every if e not in special],
                       weights.sub_seed(seed, "kimi"), device, dtype)
    g = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, "kimi:gates"))
    for name, shape in special:
        leaf = name.rsplit(".", 1)[-1]
        u = torch.rand(shape, generator=g, device=device)
        if leaf == "A_log":
            t = (1 + 15 * u).log()
        elif leaf == "dt_bias":
            t = inverse_softplus_dt(u)
        else:
            t = torch.randn(shape, generator=g, device=device) * weights.STD
        out[name] = t.to(dtype)
    return out
