"""Build and load the hand-written CUDA kernels of this package.

The sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, and loaded with
``ctypes``. The library lands in ``metatransformer_tpu_torch/_build/``
under a name keyed by a hash of the sources and flags, so a changed source
builds anew and an unchanged one is reused. There is no fallback: a
missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = (_CSRC / "fused_block.cu",)
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, bias, xn, qkv, o, out,
    # B, T, D, H, eps, stream
    "mt_attn_sublayer": [_vp] * 12 + [_int] * 4 + [_float, _vp],
    # x, ln_s, ln_b, w1, b1, w2, b2, xn, h, out, rows, D, F, eps, stream
    "mt_mlp_sublayer": [_vp] * 10 + [_int] * 3 + [_float, _vp],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _SOURCES:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmt_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if the keyed library is missing; return its path."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *FLAGS, "-o", tmp, *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.mt_error_string.argtypes = [ctypes.c_int]
    lib.mt_error_string.restype = ctypes.c_char_p
    return lib
