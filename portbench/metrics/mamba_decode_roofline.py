"""The Mamba decode step's share of its roofline: the bound of every
``mamba_decode`` call of the Granite-4.0-H model (the attribute
``models/granite_hybrid.py`` resolves: each decode step's, and the
prefill's token by token) ÷ the device time of the operations launched
under it.

Bytes per call from its arguments: the state (H·P·N) and the convolution
window (3 × C channels) of each distinct parent read once, counted on the
device from the parent index copied at the call (a parent of −1 reads
nothing) and read after the trace; every row's new state and window
written; xBC and dt in, y out; the taps, the bias, A_log, D and dt_bias;
the parents.  Counting every row's parent read would count a parent shared
by several beams as often as it has children.  Operations: 5·P·N per row
and head (the decay, the rank-one update, h·C), against the float32 peak
outside the tensor cores.
"""
import torch

from portbench.readers import roofline_pct

LAYER = "Mamba recurrence"
MOVES = "captions_per_s"
ENTRY = "clipcap_tpu_torch.models.granite_hybrid:mamba_decode"
NAME = "mamba_decode_roofline"


class _Call:
    """(bytes, operations, dtype) of one call, unpacked when read."""

    def __init__(self, xbc, dt, parent, s_src):
        B, C = xbc.shape
        H, P, N = s_src.shape[1:]
        size = xbc.element_size()
        self.ops = 5 * B * H * P * N
        self.per_parent = (H * P * N + 3 * C) * size
        self.fixed = (B * self.per_parent + B * (C + H + H * P) * size
                      + (5 * C + 3 * H) * size + 4 * B)
        seen = torch.zeros(s_src.shape[0], device=parent.device)
        seen.scatter_reduce_(0, parent.long().clamp_min(0), (parent >= 0).float(), "amax")
        self.parents = seen.sum()

    def __iter__(self):
        nbytes = self.fixed + int(self.parents) * self.per_parent
        return iter((nbytes, self.ops, "float32"))


def facts(xbc, dt, conv_w, conv_b, A_log, D, dt_bias, parent, conv_src, conv_dst, s_src, s_dst,
          *_, **__):
    return _Call(xbc, dt, parent, s_src)


def read(ctx):
    return roofline_pct(ctx, NAME)
