"""Latent attention's share of its roofline: the bound of every
``mla_decode`` call of the DeepSeek-V2 decode steps (the attribute
``models/deepseek_v2.py`` resolves) ÷ the device time of the operations
launched under it.

Bytes and operations per call from its arguments: the latent slots
visible to some beam of each sample, each read once (C + r values a
slot), the queries read and the outputs written once; 2·((C + r) + C)
operations per head, row and slot visible to the row (the score and the
weighted sum).  The visible slots are counted on the device from the
mask at the call and read after the trace.
"""
import torch

from portbench.readers import dtype_name, roofline_pct

LAYER = "decode attention"
MOVES = "captions_per_s"
ENTRY = "clipcap_tpu_torch.models.deepseek_v2:mla_decode"
NAME = "mla_decode_roofline"


class _Call:
    """(bytes, operations, dtype) of one call, unpacked when read."""

    def __init__(self, q, cache, mask, u_valid, rank):
        R, K, H, Dq = q.shape
        self.H, self.Dq, self.rank = H, Dq, rank
        self.size, self.dtype = q.element_size(), dtype_name(q)
        self.qo_values = R * K * H * (Dq + rank)
        seen = mask[..., :u_valid] == 0                                   # [R, K, U]
        self.counts = torch.stack([seen.any(1).sum(), seen.sum()])

    def __iter__(self):
        sample_slots, row_slots = self.counts.tolist()
        nbytes = (sample_slots * self.Dq + self.qo_values) * self.size
        return iter((nbytes, 2 * (self.Dq + self.rank) * self.H * row_slots, self.dtype))


def facts(q, cache, mask, u_valid, scale, rank, **_):
    return _Call(q, cache, mask, u_valid, rank)


def read(ctx):
    return roofline_pct(ctx, NAME)
