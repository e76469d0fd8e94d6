from clipcap_tpu_torch.init.base import init

__all__ = ["init"]
