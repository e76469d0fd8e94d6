"""Encoder attention's share of its roofline: the bound of every
``sdpa_packed`` call of the image tower's blocks (the attribute
``models/clip_vit.py`` resolves) ÷ the device time of the kernels launched
under it.  Per call (``chip_smoke.py``'s ``attention_bound``): the packed
``[B, N, 3D]`` qkv read and the ``[B, N, D]`` context written once;
4·N²·D operations per sample (4·N(N+1)/2·D under causal)."""
from portbench.readers import dtype_name, roofline_pct

LAYER = "encoder attention"
MOVES = "embeds_per_s"
ENTRY = "clipcap_tpu_torch.models.clip_vit:sdpa_packed"
NAME = "sdpa_packed_roofline"


def facts(qkv, heads, *, scale=None, causal=False):
    B, N, threeD = qkv.shape
    D = threeD // 3
    pairs = N * (N + 1) // 2 if causal else N * N
    return 4 * B * N * D * qkv.element_size(), 4 * B * pairs * D, dtype_name(qkv)


def read(ctx):
    return roofline_pct(ctx, NAME)
