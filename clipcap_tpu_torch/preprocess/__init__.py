from clipcap_tpu_torch.preprocess.preprocess import preprocess, start_preprocess

__all__ = ["preprocess", "start_preprocess"]
