"""The port's configs: the JAX package's config dataclasses and YAML
round-trip (``clipcap_tpu/config.py`` imports no JAX), so a YAML written by
either package loads in the other."""
from clipcap_tpu.config import (Config, EncoderConfig, TrainingConfig, load_yaml_config,
                                save_yaml_config)

__all__ = ["Config", "EncoderConfig", "TrainingConfig", "load_yaml_config", "save_yaml_config"]
