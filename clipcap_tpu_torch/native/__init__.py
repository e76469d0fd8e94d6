"""Native (C++) components: PTB tokenizer + METEOR scorer core.

Built at first use with ``make -C clipcap_tpu_torch/native OUT=...`` into
``build/clipcap_tpu_torch/native/libclipcap_native.so`` at the root of the
checkout (a directory git ignores; no library is kept in the sources);
loaded lazily through ctypes.  The Python implementations in
``clipcap_tpu_torch.eval`` define the behavior — the native versions are
cross-tested drop-ins (the reference's equivalents are Java subprocesses,
SURVEY.md §2.2).

A library that make has just written is first run in a fresh interpreter
that has loaded PyTorch, as the eval process has (load; tokenize, stem,
build a METEOR scorer on a synonym table and score a pair).  A toolchain
whose output does not run beside PyTorch's C++ runtime (an environment
``CXX`` wrapper that links no libstdc++, for one) gives a library that
crashes there, or runs away in host memory; such a library is removed
and the callers fall back to the Python implementations.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                          "clipcap_tpu_torch", "native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libclipcap_native.so")
_lib: Optional[ctypes.CDLL] = None

_CHECK = r"""
import ctypes, os, sys, tempfile
import torch  # the scorers run beside PyTorch's own C++ runtime
lib = ctypes.CDLL(sys.argv[1])
P, S = ctypes.c_void_p, ctypes.c_char_p
for name, args, res in (("ccn_ptb_tokenize", [S], P), ("ccn_free", [P], None),
                        ("ccn_porter_stem", [S], P), ("ccn_snowball_stem", [S], P),
                        ("ccn_meteor_new", [S, S, S], P), ("ccn_meteor_delete", [P], None),
                        ("ccn_meteor_stats", [P, S, S, ctypes.POINTER(ctypes.c_double)], None)):
    getattr(lib, name).argtypes, getattr(lib, name).restype = args, res
for fn in (lib.ccn_ptb_tokenize, lib.ccn_porter_stem, lib.ccn_snowball_stem):
    lib.ccn_free(fn(b"Running dogs' toys."))
fd, flat = tempfile.mkstemp()
with os.fdopen(fd, "w") as f:
    f.write("dog 1 2\nhound 2\ncat 3\n")
try:
    h = lib.ccn_meteor_new(None, None, flat.encode())
    stats = (ctypes.c_double * 7)()
    lib.ccn_meteor_stats(h, b"a dog runs home", b"the hound ran home", stats)
    lib.ccn_meteor_delete(h)
finally:
    os.remove(flat)
"""


def build(quiet: bool = True) -> bool:
    """Compile the shared library into the build directory; a library make
    has just written must pass the check in a fresh interpreter, or it is
    removed. Returns success."""
    try:
        os.makedirs(_BUILD_DIR, exist_ok=True)
        before = os.path.getmtime(_LIB_PATH) if os.path.exists(_LIB_PATH) else None
        subprocess.run(
            ["make", "-C", _DIR, f"OUT={_LIB_PATH}"],
            check=True,
            capture_output=quiet,
        )
    except Exception:
        return False
    if os.path.getmtime(_LIB_PATH) != before:
        try:
            subprocess.run([sys.executable, "-c", _CHECK, _LIB_PATH], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
            os.remove(_LIB_PATH)
            return False
    return True


def load(auto_build: bool = True) -> ctypes.CDLL:
    """Load (building if needed) the native library; raises if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    if auto_build:
        # make is incremental: a no-op when the .so is newer than the
        # sources, a rebuild when they changed (a stale library would
        # otherwise be loaded with mismatched symbol signatures).
        build()
    lib = ctypes.CDLL(_LIB_PATH)

    lib.ccn_ptb_tokenize.argtypes = [ctypes.c_char_p]
    lib.ccn_ptb_tokenize.restype = ctypes.c_void_p
    lib.ccn_free.argtypes = [ctypes.c_void_p]
    lib.ccn_free.restype = None
    lib.ccn_meteor_new.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                   ctypes.c_char_p]
    lib.ccn_meteor_new.restype = ctypes.c_void_p
    lib.ccn_meteor_delete.argtypes = [ctypes.c_void_p]
    lib.ccn_meteor_delete.restype = None
    lib.ccn_meteor_stats.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                     ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_double)]
    lib.ccn_meteor_stats.restype = None
    lib.ccn_meteor_score_from_stats.argtypes = [ctypes.POINTER(ctypes.c_double)]
    lib.ccn_meteor_score_from_stats.restype = ctypes.c_double
    lib.ccn_porter_stem.argtypes = [ctypes.c_char_p]
    lib.ccn_porter_stem.restype = ctypes.c_void_p
    lib.ccn_snowball_stem.argtypes = [ctypes.c_char_p]
    lib.ccn_snowball_stem.restype = ctypes.c_void_p

    _lib = lib
    return lib


def available() -> bool:
    try:
        load()
        return True
    except Exception:
        return False


def _take_string(lib: ctypes.CDLL, ptr: int) -> str:
    try:
        return ctypes.string_at(ptr).decode("utf-8", errors="replace")
    finally:
        lib.ccn_free(ptr)
