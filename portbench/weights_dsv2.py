"""Seeded DeepSeek-V2 weights for the benchmark, made on the device.

The same values as ``weights.py`` gives every model (matrices N(0, 0.02),
norm scales 1; DeepSeek-V2 has no biases), under HF
``DeepseekV2ForCausalLM`` keys with each MoE layer's routed experts stacked
(``mlp.experts.gate_up_proj`` [E, 2F, D], gate | up, and
``mlp.experts.down_proj`` [E, D, F]), from one ``randn``.  ``cfg`` is the
configuration file: its HF ``config.json`` keys sit at the top level.
"""
from __future__ import annotations

from portbench import weights


def shapes(c: dict) -> list:
    D, V, H = c["hidden_size"], c["vocab_size"], c["num_attention_heads"]
    nope, r, vd, C = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                      c["kv_lora_rank"])
    E, Fm = c["n_routed_experts"], c["moe_intermediate_size"]
    out = [("model.embed_tokens.weight", (V, D))]
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        out += [(p + "input_layernorm.weight", (D,)),
                (p + "self_attn.q_proj.weight", (H * (nope + r), D)),
                (p + "self_attn.kv_a_proj_with_mqa.weight", (C + r, D)),
                (p + "self_attn.kv_a_layernorm.weight", (C,)),
                (p + "self_attn.kv_b_proj.weight", (H * (nope + vd), C)),
                (p + "self_attn.o_proj.weight", (D, H * vd)),
                (p + "post_attention_layernorm.weight", (D,))]
        if i >= c["first_k_dense_replace"] and i % c["moe_layer_freq"] == 0:
            Fs = Fm * c["n_shared_experts"]
            out += [(p + "mlp.gate.weight", (E, D)),
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


def dsv2(cfg: dict, seed: int, device, dtype) -> dict:
    return weights.make(shapes(cfg), weights.sub_seed(seed, "dsv2"), device, dtype)
