"""GPT-2 weights from HF checkpoints already on disk.

Counterpart of ``clipcap_tpu/models/hf_import.py::load_gpt2``.  The port's
:class:`~clipcap_tpu_torch.models.gpt2.GPT2` keeps HF ``GPT2Model`` keys,
so an HF state dict loads as it is, less the ``transformer.`` prefix, the
tied ``lm_head`` and the attention-mask buffers.  Nothing here fetches:
the HF cache is read with ``local_files_only``.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Mapping

import torch

from clipcap_tpu_torch.models.gpt2 import GPT2, GPT2_PRESETS, GPT2Config, init_gpt2


def gpt2_config_from_hf(hf_config: dict) -> GPT2Config:
    return GPT2Config(
        vocab_size=hf_config["vocab_size"],
        n_positions=hf_config["n_positions"],
        n_embd=hf_config["n_embd"],
        n_layer=hf_config["n_layer"],
        n_head=hf_config["n_head"],
        layer_norm_epsilon=hf_config.get("layer_norm_epsilon", 1e-5),
        activation="gelu_new",
        name=hf_config.get("_name_or_path", "gpt2-custom") or "gpt2-custom",
    )


def gpt2_from_hf(state_dict: Mapping[str, torch.Tensor], cfg: GPT2Config) -> GPT2:
    """A :class:`GPT2` from an HF ``GPT2LMHeadModel`` / ``GPT2Model`` state
    dict (fp32)."""
    model = GPT2(cfg)
    want = model.state_dict().keys()
    sd = {}
    for key, value in state_dict.items():
        key = key[len("transformer."):] if key.startswith("transformer.") else key
        if key in want:
            sd[key] = value.detach().float().cpu()
    model.load_state_dict(sd)
    return model


def _load_state_dict(path: str) -> dict:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    return torch.load(path, map_location="cpu", weights_only=True)


def load_gpt2(name_or_path: str) -> GPT2:
    """Resolve a GPT-2 as the JAX package does, without the network:

    1. a local directory with ``config.json`` and HF weights;
    2. the HF cache through ``transformers`` (``local_files_only``);
    3. for a preset name, the weights of ``init_gpt2(cfg, seed=0)`` (the
       JAX package's draws), with a warning.
    """
    if os.path.isdir(name_or_path):
        with open(os.path.join(name_or_path, "config.json")) as f:
            cfg = gpt2_config_from_hf(json.load(f))
        for fname in ("model.safetensors", "pytorch_model.bin"):
            path = os.path.join(name_or_path, fname)
            if os.path.exists(path):
                return gpt2_from_hf(_load_state_dict(path), cfg)
        raise FileNotFoundError(f"no weights file in {name_or_path}")

    if name_or_path == "gpt2-test":          # test preset: no pretrained weights
        return _seeded(GPT2_PRESETS[name_or_path])

    try:
        from transformers import AutoModelForCausalLM

        hf = AutoModelForCausalLM.from_pretrained(name_or_path, local_files_only=True)
        return gpt2_from_hf(hf.state_dict(), gpt2_config_from_hf(hf.config.to_dict()))
    except (ImportError, OSError, ValueError):
        pass

    if name_or_path in GPT2_PRESETS:
        warnings.warn(
            f"No pretrained weights for '{name_or_path}' on disk. Using RANDOM "
            "initialization — fine for benchmarks and training from scratch, "
            "wrong for pretrained captioning.")
        return _seeded(GPT2_PRESETS[name_or_path])
    raise ValueError(f"cannot resolve language model '{name_or_path}'")


def _seeded(cfg: GPT2Config) -> GPT2:
    from clipcap_tpu_torch.convert import gpt2_from_params

    return gpt2_from_params(init_gpt2(cfg, seed=0), cfg)
