"""Seeded Granite-4.0-H weights for the benchmark, made on the device.

The port's keys (``models/granite_hybrid.py``): the published ones, the
held experts stacked (``mlp.experts.gate_up_proj`` [E_held, 2F, D], gate |
up, and ``mlp.experts.down_proj`` [E_held, D, F]), the router
``mlp.gate.weight`` over all experts and the shared MLP
``mlp.shared_experts.input_linear`` / ``output_linear``; no head (it is
tied to ``model.embed_tokens``).  Matrices come from one ``randn`` as
``weights.make`` gives every model (N(0, 0.02), norm scales 1); the Mamba
mixers' convolution taps and bias (U(−1/2, 1/2), ``nn.Conv1d``'s default),
``A_log`` (ln U(1, 16)), ``dt_bias`` (softplus⁻¹ of a log-uniform step in
[0.001, 0.1]), Mamba-2's initialisation, and ``D`` (1) from a generator of
their own.  ``cfg`` is the configuration file: the model's ``config.json``
keys at the top level, ``num_local_experts`` the experts held here
(``experts_held``).
"""
from __future__ import annotations

import torch

from clipcap_tpu_torch.models.kimi_linear import inverse_softplus_dt

from portbench import weights

SPECIAL = ("conv1d.weight", "conv1d.bias", "A_log", "dt_bias", "D")


def shapes(c: dict) -> list:
    D, V = c["hidden_size"], c["vocab_size"]
    H, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    Dh = D // H
    Hm, Pm, Nm = c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"]
    inner = c["mamba_expand"] * D
    C = inner + 2 * c["mamba_n_groups"] * Nm
    E, Fm, Fs = c["num_local_experts"], c["intermediate_size"], c["shared_intermediate_size"]
    out = [("model.embed_tokens.weight", (V, D))]
    for i, kind in enumerate(c["layer_types"]):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (D,))]
        if kind == "mamba":
            m = p + "mamba."
            out += [(m + "in_proj.weight", (inner + C + Hm, D)),
                    (m + "conv1d.weight", (C, 1, c["mamba_d_conv"])), (m + "conv1d.bias", (C,)),
                    (m + "dt_bias", (Hm,)), (m + "A_log", (Hm,)), (m + "D", (Hm,)),
                    (m + "norm.weight", (inner,)), (m + "out_proj.weight", (D, inner))]
        else:
            a = p + "self_attn."
            out += [(a + "q_proj.weight", (H * Dh, D)), (a + "k_proj.weight", (Hkv * Dh, D)),
                    (a + "v_proj.weight", (Hkv * Dh, D)), (a + "o_proj.weight", (D, H * Dh))]
        out += [(p + "post_attention_layernorm.weight", (D,)),
                (p + "mlp.gate.weight", (c["num_local_experts_published"], D)),
                (p + "mlp.experts.gate_up_proj", (E, 2 * Fm, D)),
                (p + "mlp.experts.down_proj", (E, D, Fm)),
                (p + "mlp.shared_experts.input_linear.weight", (2 * Fs, D)),
                (p + "mlp.shared_experts.output_linear.weight", (D, Fs))]
    return out + [("model.norm.weight", (D,))]


def _special(name: str) -> str:
    return next((s for s in SPECIAL if name.endswith("mamba." + s)), "")


def granite(cfg: dict, seed: int, device, dtype) -> dict:
    every = shapes(cfg)
    special = [(n, s) for n, s in every if _special(n)]
    out = weights.make([e for e in every if not _special(e[0])],
                       weights.sub_seed(seed, "granite"), device, dtype)
    g = torch.Generator(device=device).manual_seed(weights.sub_seed(seed, "granite:mamba"))
    for name, shape in special:
        kind = _special(name)
        u = torch.rand(shape, generator=g, device=device)
        if kind == "A_log":
            t = (1 + 15 * u).log()
        elif kind == "dt_bias":
            t = inverse_softplus_dt(u)
        elif kind == "D":
            t = torch.ones(shape, device=device)
        else:
            t = u - 0.5
        out[name] = t.to(dtype)
    return out
