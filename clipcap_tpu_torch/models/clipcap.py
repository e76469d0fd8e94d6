"""The assembled ClipCap model: mapping network + GPT-2 decoder.

Counterpart of ``clipcap_tpu/models/clipcap.py`` (serving half).
:class:`ClipCapModel` holds the reference's two submodules,
``language_model`` and ``transformer_mapper``, so its state dict carries the
reference's key prefixes; :func:`load` reads the JAX package's ``.npz`` +
YAML checkpoints.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch import nn

from clipcap_tpu_torch.config import Config
from clipcap_tpu_torch.models.gpt2 import GPT2, GPT2Config, get_gpt2_config, init_gpt2
from clipcap_tpu_torch.models.mapper import MapperConfig, TransformerMapper, init_mapper
from clipcap_tpu_torch.utils.device import resolve_device


class ClipCapModel(nn.Module):
    """``language_model`` (GPT-2) + ``transformer_mapper``;
    ``model.transformer_mapper(embeddings)`` maps encoder embeddings to the
    LM prefix, as in the reference's demo."""

    def __init__(self, config: Config, language_model: GPT2,
                 transformer_mapper: TransformerMapper):
        super().__init__()
        self.config = config
        self.language_model = language_model
        self.transformer_mapper = transformer_mapper

    @property
    def lm_config(self) -> GPT2Config:
        return self.language_model.config

    @property
    def mapper_config(self) -> MapperConfig:
        return self.transformer_mapper.config

    @property
    def prefix_length(self) -> int:
        return self.config.prefix_length

    @property
    def device(self) -> torch.device:
        return self.language_model.wte.weight.device

    def params(self) -> dict:
        """The JAX package's parameter tree ``{"mapper", "lm"}`` (numpy)."""
        from clipcap_tpu_torch.convert import gpt2_params, mapper_params

        return {"mapper": mapper_params(self.transformer_mapper),
                "lm": gpt2_params(self.language_model)}


def build_mapper_config(config: Config, lm_embedding_size: int) -> MapperConfig:
    """The reference's wiring: the windowed mapper gets ``window_size + 1``
    windows (global + tiles)."""
    enc = config.encoder_config
    window = None
    use_pos = False
    if enc is not None and enc.use_windowed_embeddings:
        window = enc.window_size + 1
        use_pos = config.use_positional_embeddings
    return MapperConfig(
        encoder_embedding_size=enc.encoder_embedding_size if enc else 512,
        lm_embedding_size=lm_embedding_size,
        prefix_length=config.prefix_length,
        projection_length=config.projection_length,
        num_heads=config.transformer_attention_heads,
        num_layers=config.transformer_layers,
        window_size=window,
        use_pos_embeddings=use_pos,
    )


def model_from_params(config: Config, params: dict,
                      lm_config: Optional[GPT2Config] = None) -> ClipCapModel:
    """A :class:`ClipCapModel` from the parameter tree ``{"mapper", "lm"}``."""
    from clipcap_tpu_torch.convert import gpt2_from_params, mapper_from_params

    lm_config = lm_config or get_gpt2_config(config.language_model)
    mapper_config = build_mapper_config(config, lm_config.n_embd)
    return ClipCapModel(config, gpt2_from_params(params["lm"], lm_config),
                        mapper_from_params(params["mapper"], mapper_config))


def init_clipcap(config: Config, lm_config: Optional[GPT2Config] = None,
                 seed: int = 0) -> ClipCapModel:
    """A ClipCap model with seeded weights — the JAX package's
    ``init_clipcap(config, lm_config=…, seed=…)`` draws (there are no
    pretrained weights offline)."""
    lm_config = lm_config or get_gpt2_config(config.language_model)
    mapper_config = build_mapper_config(config, lm_config.n_embd)
    params = {"mapper": init_mapper(mapper_config, seed=seed),
              "lm": init_gpt2(lm_config, seed=seed)}
    return model_from_params(config, params, lm_config)


def load(model_path: str, config_path: str, device="cuda",
         from_checkpoint: bool = False) -> Tuple[ClipCapModel, Any]:
    """Load a model (``.npz`` written by either package) and its YAML config
    onto ``device``, plus the tokenizer.  ``device="cuda"`` raises when
    CUDA is absent."""
    from clipcap_tpu_torch.config import load_yaml_config
    from clipcap_tpu.utils.tokenizer import get_tokenizer
    from clipcap_tpu_torch.train.checkpoint import restore_params

    dev = resolve_device(device)
    config = load_yaml_config(config_path)
    if from_checkpoint:
        config.training_config = None
    model = model_from_params(config, restore_params(model_path))
    return model.to(dev), get_tokenizer(config.language_model)
