"""Patch embedding's share of its roofline: the bound of every
``patch_embed`` call of the image tower (the attribute ``models/clip_vit.py``
resolves) ÷ the device time of the kernels launched under it.  Per call
(``chip_smoke.py``'s ``time_patch_embed``): the uint8 images, the bf16
weight and bias read and the ``[M, D]`` patches written once, M = B·(H/P)·(W/P);
2·M·3P²·D operations."""
from portbench.readers import dtype_name, roofline_pct

LAYER = "patch embedding"
MOVES = "embeds_per_s"
ENTRY = "clipcap_tpu_torch.models.clip_vit:patch_embed"
NAME = "patch_embed_roofline"


def facts(images, w, bias, patch):
    B, H, W, _ = images.shape
    M, K, D = B * (H // patch) * (W // patch), w.shape[0], w.shape[1]
    nbytes = (images.numel() * images.element_size()
              + w.element_size() * (w.numel() + (D if bias is not None else 0) + M * D))
    return nbytes, 2 * M * K * D, dtype_name(w)


def read(ctx):
    return roofline_pct(ctx, NAME)
