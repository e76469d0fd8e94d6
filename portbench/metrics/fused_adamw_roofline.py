"""The optimizer's share of its roofline: the bound of every
``fused_adamw`` call of the AdamW update (the attribute ``train/state.py``
resolves) ÷ the device time of the kernels launched under it.  Per call
(``chip_smoke.py``'s ``check_adamw``): 28 bytes an element (p, g, m, v read
as fp32; p, m, v written) and ~16 fp32 operations an element, at the fp32
peak."""
from portbench.readers import roofline_pct

LAYER = "optimizer"
MOVES = "train_samples_per_s"
ENTRY = "clipcap_tpu_torch.train.state:fused_adamw"
NAME = "fused_adamw_roofline"


def facts(params, grads, exp_avgs, exp_avg_sqs, scalars):
    n = sum(p.numel() for p in params)
    return 28 * n, 16 * n, "float32"


def read(ctx):
    return roofline_pct(ctx, NAME)
