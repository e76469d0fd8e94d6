"""QuickGELU's share of its roofline: the bound of every ``quick_gelu``
call of the image tower's blocks (the attribute ``models/clip_vit.py``
resolves) ÷ the device time of the kernels launched under it.  Per call
(``chip_smoke.py``'s ``run_quick_gelu``): ``x`` read and the output written
once, 2·numel·element_size bytes; 5 operations an element, far under the
bytes' time."""
from portbench.readers import dtype_name, roofline_pct

LAYER = "MLP activation"
MOVES = "embeds_per_s"
ENTRY = "clipcap_tpu_torch.models.clip_vit:quick_gelu"
NAME = "quick_gelu_roofline"


def facts(x):
    return 2 * x.numel() * x.element_size(), 5 * x.numel(), dtype_name(x)


def read(ctx):
    return roofline_pct(ctx, NAME)
