"""The routed experts' share of their roofline: the bound of every
``grouped_expert_mlp`` call the DeepSeek-V2 model makes (the attribute
``models/deepseek_v2.py`` resolves, whatever kernels are behind it: the
prefill's and each decode step's) ÷ the device time of the kernels
launched under it.

Bytes and operations per call from its arguments: the weights of every
expert that got at least one row (2F·D + D·F values, from the device
offsets, copied at the call and read after the trace), the rows in and
the rows out once (M·D each); 6·M·D·F operations (gate | up, then down).
"""
import torch

from portbench.readers import dtype_name, roofline_pct

LAYER = "routed experts"
MOVES = "captions_per_s"
ENTRY = "clipcap_tpu_torch.models.deepseek_v2:grouped_expert_mlp"
NAME = "moe_experts_roofline"


class _Call:
    """(bytes, operations, dtype) of one call, unpacked when read."""

    def __init__(self, x, w2, offsets):
        self.M, self.D = x.shape
        self.F = w2.shape[-1]
        self.size, self.dtype = x.element_size(), dtype_name(x)
        self.offsets = offsets.clone()

    def __iter__(self):
        used = int((torch.diff(self.offsets) > 0).sum())
        nbytes = (used * 3 * self.D * self.F + 2 * self.M * self.D) * self.size
        return iter((nbytes, 6 * self.M * self.D * self.F, self.dtype))


def facts(x, w13, w2, offsets, **_):
    return _Call(x, w2, offsets)


def read(ctx):
    return roofline_pct(ctx, NAME)
