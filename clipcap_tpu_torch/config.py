"""Config dataclasses + YAML round-trip.

The port's own copy of ``clipcap_tpu/config.py``.  Field names and YAML
layout match the reference ``clipcap`` package's model and encoder configs
exactly, so ``encoder_config.yaml`` / ``<prefix>_config.yaml`` files written by the
PyTorch reference or by the JAX package load unchanged here, and vice
versa.

Reference default divergences documented in SURVEY.md are kept as the
reference wrote them (e.g. ``transformer_attention_heads`` defaults to 16 in
the config but 8 in the CLI args — both preserved).
"""
from __future__ import annotations

import dataclasses
from argparse import Namespace
from dataclasses import dataclass
from typing import Optional


@dataclass
class EncoderConfig:
    encoder_model_name: str = "clip"
    encoder_model_variant: str = "ViT-L/14"
    encoder_embedding_size: Optional[int] = None  # discovered during dataloading
    normalize_embeddings: bool = False

    use_windowed_embeddings: bool = False
    window_size: int = 4 * 4
    window_overlap_percentage: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_args(cls, args: Namespace) -> "EncoderConfig":
        return cls(
            encoder_model_name=args.encoder_model_name,
            encoder_model_variant=args.encoder_model_variant,
            encoder_embedding_size=None,
            normalize_embeddings=args.normalize_embeddings,
            use_windowed_embeddings=args.use_windowed_embeddings,
            window_size=args.window_size,
            window_overlap_percentage=args.window_overlap_percentage,
        )


@dataclass
class TrainingConfig:
    optimizer_lr: float = 2e-5
    # Kept for YAML compatibility with the reference (deepspeed FusedAdam
    # flag). Here it has no effect: ``--fused-optimizer`` picks the
    # optimizer.
    use_deepspeed_optimisers: bool = True
    scheduler_warmup_steps: int = 123
    total_steps: int = 123

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_args(cls, args: Namespace) -> "TrainingConfig":
        return cls(
            optimizer_lr=args.optimizer_lr,
            use_deepspeed_optimisers=getattr(args, "enable_deepspeed", False),
            scheduler_warmup_steps=args.scheduler_warmup_steps,
            total_steps=args.total_steps,
        )


@dataclass
class Config:
    language_model: str = "gpt2-xl"
    train_language_model: bool = False
    prefix_length: int = 10
    projection_length: int = 10
    transformer_layers: int = 8
    transformer_attention_heads: int = 16
    use_positional_embeddings: bool = True

    encoder_config: Optional[EncoderConfig] = None
    training_config: Optional[TrainingConfig] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_args(cls, args: Namespace) -> "Config":
        return cls(
            language_model=args.language_model,
            train_language_model=args.train_language_model,
            prefix_length=args.prefix_length,
            projection_length=args.projection_length,
            transformer_layers=args.transformer_layers,
            transformer_attention_heads=args.transformer_attention_heads,
            use_positional_embeddings=args.use_positional_embeddings,
            encoder_config=None,
            training_config=None,
        )

    @classmethod
    def from_dict(cls, raw: dict) -> "Config":
        raw = dict(raw)
        if raw.get("encoder_config") is not None and not isinstance(
            raw["encoder_config"], EncoderConfig
        ):
            raw["encoder_config"] = EncoderConfig(**raw["encoder_config"])
        if raw.get("training_config") is not None and not isinstance(
            raw["training_config"], TrainingConfig
        ):
            raw["training_config"] = TrainingConfig(**raw["training_config"])
        return cls(**raw)


def save_yaml_config(config, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.dump(config.to_dict(), f, default_flow_style=False)


def load_yaml_config(path: str) -> Config:
    import yaml

    with open(path, "r") as f:
        return Config.from_dict(yaml.safe_load(f))
