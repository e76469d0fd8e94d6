"""The KDA decode step's share of its roofline: the bound of every
``kda_decode`` call of the Kimi-Linear model (the attribute
``models/kimi_linear.py`` resolves: each decode step's, and the prefill's
token by token) ÷ the device time of the operations launched under it.

Bytes per call from its arguments: the state (H·d² float32) and the
convolution window (3 × 3 × H·d) of each distinct parent read once, counted
on the device from the parent index copied at the call (a parent of −1
reads nothing) and read after the trace; every row's new state and window
written; q, k, v in, g and β in, o out, the taps, the parents.  Counting
every row's parent read would count a parent shared by several beams as
often as it has children.  Operations: 7·d² per row and head (the decay,
Sᵀk, the rank-one update, Sᵀq), against the float32 peak outside the tensor
cores.
"""
import torch

from portbench.readers import roofline_pct

LAYER = "KDA recurrence"
MOVES = "captions_per_s"
ENTRY = "clipcap_tpu_torch.models.kimi_linear:kda_decode"
NAME = "kda_decode_roofline"


class _Call:
    """(bytes, operations, dtype) of one call, unpacked when read."""

    def __init__(self, q, g, parent, s_src):
        B, HD = q.shape
        H, d = g.shape[1], g.shape[2]
        self.ops = 7 * B * H * d * d
        size = q.element_size()
        self.per_parent = H * d * d * 4 + 9 * HD * size
        self.fixed = (B * self.per_parent + 4 * B * HD * size + B * H * (d + 1) * 4
                      + 3 * HD * 4 * size + 4 * B)
        seen = torch.zeros(s_src.shape[0], device=parent.device)
        seen.scatter_reduce_(0, parent.long().clamp_min(0), (parent >= 0).float(), "amax")
        self.parents = seen.sum()

    def __iter__(self):
        nbytes = self.fixed + int(self.parents) * self.per_parent
        return iter((nbytes, self.ops, "float32"))


def facts(q, k, v, wq, wk, wv, g, beta, parent, conv_src, conv_dst, s_src, s_dst, *_, **__):
    return _Call(q, g, parent, s_src)


def read(ctx):
    return roofline_pct(ctx, NAME)
