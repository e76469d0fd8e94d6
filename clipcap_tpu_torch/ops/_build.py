"""Build the port's CUDA kernels from ``csrc/`` and bind them with ctypes.

The sources are compiled at first use with ``nvcc``, one process per
source, all started together, and linked into one shared library with a
plain C interface (no PyTorch headers, so a build takes seconds, not
minutes).  The library lands in ``build/clipcap_tpu_torch/``
at the root of the checkout and is named after a hash of the sources and
flags, so an edit to any source rebuilds it and a stale library is never
loaded.  Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
The launch goes to the CUDA runtime's current device, so each wrapper
makes its tensors' device current around the call (``torch.cuda.device``).

Nothing here runs at import time: the CPU-only test machines import every
module of the port and never build.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "clipcap_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the C interface (csrc/common.cuh ``DType``).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # q, kv, sk, sv, mask, out, m_in, l_in, acc_in, m_out, l_out, acc_out,
    # lo_vec, hi_vec, R, H, K, U, Rm, lo, hi, dtype, scale, stream
    "clipcap_flash_decode": [_P] * 14 + [_I] * 8 + [_F, _P],
    # q, skv, ssk, ssv, smask, Us, sRm, sh_hi_vec, sh_hi, lkv, lsk, lsv,
    # lmask, Ul, lRm, lv_lo_vec, lv_lo, lv_hi_vec, lv_hi, out, R, H, K,
    # dtype, scale, stream
    "clipcap_flash_decode_two_phase": [_P] * 5 + [_I, _I, _P, _I] + [_P] * 4
    + [_I, _I, _P, _I, _P, _I, _P] + [_I] * 4 + [_F, _P],
    # qkv, out, B, N, H, causal, dtype, scale, stream
    "clipcap_sdpa_packed": [_P, _P, _I, _I, _I, _I, _I, _F, _P],
    # table, n, total, lr, b1, b2, eps, wd, bc1, bc2, stream
    "clipcap_fused_adamw": [_P, _I, _L, _F, _F, _F, _F, _F, _F, _F, _P],
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libclipcap_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        candidate = os.path.join(CUDA_HOME, "bin", "nvcc")
        found = candidate if os.path.exists(candidate) else None
    if found is None:
        raise RuntimeError("nvcc not found (PATH or CUDA_HOME): the port's "
                           "CUDA kernels cannot be built")
    return found


def build(path: Path) -> None:
    """Compile every ``csrc/*.cu`` (one ``nvcc`` each, in parallel) and link
    them into ``path``; the compiler's report (registers, shared memory,
    spills per kernel) goes to ``path``.log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{path.stem}.{os.getpid()}"
    objects, procs = [], []
    for src in (s for s in sources() if s.suffix == ".cu"):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objects.append(obj)
        procs.append(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    reports = [(p.args[-3], p.communicate()[0], p.returncode) for p in procs]
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    failed = [r for r in reports if r[2] != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objects)], capture_output=True, text=True)
        reports.append(("link", link.stdout + link.stderr, link.returncode))
        failed = [r for r in reports[-1:] if r[2] != 0]
    for obj in objects:
        obj.unlink(missing_ok=True)
    log = "".join(f"== {name} (exit {rc})\n{text}" for name, text, rc in reports)
    path.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed on {[r[0] for r in failed]}:\n{log}")
    os.replace(tmp, path)             # atomic: concurrent builders agree


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use.  Raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("the port's CUDA kernels need a CUDA device")
    path = library_path()
    if not path.exists():
        build(path)
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.clipcap_error_string.argtypes = [ctypes.c_int]
    lib.clipcap_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error."""
    if code != 0:
        text = load_library().clipcap_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} at launch ({text})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
