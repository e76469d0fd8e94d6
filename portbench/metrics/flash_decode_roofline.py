"""Decode attention's share of its roofline: the bound of every
``flash_decode`` call that GPT-2's decode step makes (the attribute
``models/gpt2.py`` resolves, whatever kernel is behind it) ÷ the device time
of the kernels launched under it.

Bytes and operations per call from its arguments (``chip_smoke.py``'s
``decode_bound``): q read and the output written once; for each of the R
cache rows the valid slots ``[u_lo, u_valid)`` of every head, K and V
(2·Dh values, plus two fp32 scales a slot for an int8 cache), and the
mask's columns over those slots for each of the K queries; 4·Dh·K
operations per slot and head.
"""
from portbench.readers import dtype_name, roofline_pct

LAYER = "decode attention"
MOVES = "captions_per_s"
ENTRY = "clipcap_tpu_torch.models.gpt2:flash_decode"
NAME = "flash_decode_roofline"


def _host(b, default: int) -> float:
    if b is None:
        return default
    return b if isinstance(b, int) else float(b.float().mean())


def facts(q, kv, mask, u_valid=None, scales=None, u_lo=None, **_):
    R, H, K, Dh = q.shape
    U = mask.shape[-1]
    Rm = mask.shape[0]
    slots = _host(u_valid, U) - _host(u_lo, 0)
    slot_bytes = 2 * Dh * kv.element_size() + (8 if scales is not None else 0)
    nbytes = 2 * q.numel() * q.element_size() + H * R * slots * slot_bytes + K * Rm * slots * 4
    return nbytes, H * R * slots * 4 * Dh * K, dtype_name(q)


def read(ctx):
    return roofline_pct(ctx, NAME)
