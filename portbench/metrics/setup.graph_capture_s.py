"""Seconds the program spent capturing its decode steps' CUDA graphs in
the process: ``utils/profiling.py::ONCE``'s ``graphs.capture``, one a
segment (its warm-up run on the capture stream, the capture, the first
replay), over every LM family.  Caption cells only; a program without the
record, or one that captured nothing, reads nothing."""
LAYER = "set-up"
MOVES = "setup_s"


def read(ctx):
    if ctx.work["kind"] != "caption":
        return None
    from clipcap_tpu_torch.utils import profiling

    once = getattr(profiling, "ONCE", None)
    return None if once is None else once.totals.get("graphs.capture")
