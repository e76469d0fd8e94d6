"""Seconds the program spent loading its CUDA kernel library in the
process: ``utils/profiling.py::ONCE``'s ``kernels.load`` (hashing the
sources, ``ctypes.CDLL``, the bindings, and an ``nvcc`` build when the
checkout has none, ``kernels.build`` inside it).  A program without the
record reads nothing."""
LAYER = "set-up"
MOVES = "setup_s"


def read(ctx):
    from clipcap_tpu_torch.utils import profiling

    once = getattr(profiling, "ONCE", None)
    return None if once is None else once.totals.get("kernels.load")
