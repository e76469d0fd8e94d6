"""The card's peaks, and the bound of a piece of work against them.

Published rates of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
full 700 W power limit): 989 TFLOP/s in bf16, 67 TFLOP/s in float32 outside
the tensor cores, 3.35 TB/s of HBM.  ``bound`` is ``chip_smoke.py::bound``:
the least time the card could take for a call, its bytes (each input read
once, each output written once) over the memory rate or its operations
over the peak rate of the dtype, whichever is larger.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}


def bound_s(nbytes: float, ops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype])
