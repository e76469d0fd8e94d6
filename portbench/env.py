"""The environment of a benchmark process, set before torch is imported."""
import os
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def setup() -> None:
    # Build and kernel caches at fixed paths inside the checkout.
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / "portbench" / sub)
    # One host thread for PyTorch's and the math libraries' CPU work: the
    # load comes from one caller, and idle worker threads spinning on a
    # shared host add noise to host-bound rates.
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
