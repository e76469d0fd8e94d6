"""What the per-layer metric files share: the idle share and the peak
share of a traced run (``ctx`` is ``harness.traced``'s namespace)."""
from __future__ import annotations

from portbench.peaks import PEAK_OPS_PER_S


def idle_pct(ctx, kind: str):
    """1 − device busy time per unit ÷ the unprofiled time per unit, in %
    (``chip_smoke.py::profile``'s idle share); None for another kind."""
    if ctx.work["kind"] != kind or ctx.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.work["units"] / ctx.unit_s)


def mfu_pct(ctx, kind: str, flops_per_unit: float, dtype: str = "bfloat16"):
    """Model FLOPs of a unit ÷ (the unprofiled time per unit × the peak),
    in %; None for another kind or a trace without device time."""
    if ctx.work["kind"] != kind or ctx.busy_s <= 0:
        return None
    return 100.0 * flops_per_unit / (ctx.unit_s * PEAK_OPS_PER_S[dtype])


def roofline_pct(ctx, name: str):
    """Σ bound of the entry's calls ÷ the device time under its range, in %;
    None when the traced units made no call or the trace holds no time."""
    from portbench.peaks import bound_s

    calls = ctx.calls.get(name) or []
    t = ctx.range_s(f"pb:{name}")
    if not calls or t is None:
        return None
    return 100.0 * sum(bound_s(*c) for c in calls) / t


def dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")
