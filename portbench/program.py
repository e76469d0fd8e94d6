"""The system under test: the port's modules, built from a configuration
file and filled with the benchmark's seeded weights.

Modules are built on the meta device (no host allocation, no init) and take
the weights with ``load_state_dict(assign=True)``, so they hold the very
tensors ``portbench.weights`` made on the card.  Everything here comes from
``clipcap_tpu_torch``; nothing of the JAX package is imported.
"""
from __future__ import annotations

import torch

from clipcap_tpu_torch.config import Config, EncoderConfig
from clipcap_tpu_torch.encoders.clip import CLIPEncoder
from clipcap_tpu_torch.models.clip_vit import CLIP, CLIPConfig, CLIPTextConfig, CLIPVisionConfig
from clipcap_tpu_torch.models.clipcap import ClipCapModel
from clipcap_tpu_torch.models.gpt2 import GPT2, GPT2Config
from clipcap_tpu_torch.models.mapper import MapperConfig, TransformerMapper

from portbench import weights

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _assign(module: torch.nn.Module, sd: dict, strict: bool = True) -> torch.nn.Module:
    missing, unexpected = module.load_state_dict(sd, strict=False, assign=True)
    if unexpected or (strict and missing):
        raise KeyError(f"weights do not fit {type(module).__name__}: missing {missing[:4]}, "
                       f"unexpected {unexpected[:4]}")
    return module


def gpt2_config(cfg: dict) -> GPT2Config:
    c = cfg["language_model"]
    return GPT2Config(vocab_size=c["vocab_size"], n_positions=c["n_positions"],
                      n_embd=c["n_embd"], n_layer=c["n_layer"], n_head=c["n_head"],
                      layer_norm_epsilon=c["layer_norm_epsilon"],
                      activation=c["activation_function"], name=cfg["name"])


def mapper_config(cfg: dict) -> MapperConfig:
    c = cfg["mapper"]
    return MapperConfig(encoder_embedding_size=c["encoder_embedding_size"],
                        lm_embedding_size=c["lm_embedding_size"],
                        prefix_length=c["prefix_length"],
                        projection_length=c["projection_length"], num_heads=c["num_heads"],
                        num_layers=c["num_layers"], mlp_ratio=c["mlp_ratio"])


def language_model(cfg: dict, seed: int, device, dtype) -> GPT2:
    with torch.device("meta"):
        lm = GPT2(gpt2_config(cfg))
    return _assign(lm, weights.gpt2(cfg, seed, device, dtype))


def mapper(cfg: dict, seed: int, device, dtype) -> TransformerMapper:
    with torch.device("meta"):
        m = TransformerMapper(mapper_config(cfg))
    return _assign(m, weights.mapper(cfg, seed, device, dtype))


def image_encoder(cfg: dict, seed: int, device, dtype) -> CLIPEncoder:
    """``CLIPEncoder`` over a CLIP whose image tower holds the seeded
    weights; its text tower is never used and stays on the meta device."""
    e = cfg["encoder"]
    vision = CLIPVisionConfig(image_size=e["image_size"], patch_size=e["patch_size"],
                              width=e["width"], layers=e["layers"], heads=e["heads"],
                              embed_dim=e["embed_dim"])
    clip_cfg = CLIPConfig(name=e["variant"], vision=vision, text=CLIPTextConfig())
    with torch.device("meta"):
        clip = CLIP(clip_cfg)
    _assign(clip, weights.clip_visual(cfg, seed, device, dtype), strict=False)
    return CLIPEncoder(clip, clip_cfg, dtype=dtype)


def clipcap(cfg: dict, seed: int, device, dtype) -> ClipCapModel:
    """The trained model: mapper + GPT-2, parameters in ``dtype``."""
    m = cfg["mapper"]
    config = Config(language_model=cfg["name"], prefix_length=m["prefix_length"],
                    projection_length=m["projection_length"],
                    transformer_layers=m["num_layers"],
                    transformer_attention_heads=m["num_heads"],
                    encoder_config=EncoderConfig(encoder_model_name=cfg["encoder"]["model"],
                                                 encoder_model_variant=cfg["encoder"]["variant"],
                                                 encoder_embedding_size=m["encoder_embedding_size"]))
    return ClipCapModel(config, language_model(cfg, seed, device, dtype),
                        mapper(cfg, seed, device, dtype))
