from clipcap_tpu_torch.encoders.base import (get_encoder, get_encoder_from_config,
                                             get_encoder_from_model)

__all__ = ["get_encoder", "get_encoder_from_config", "get_encoder_from_model"]
