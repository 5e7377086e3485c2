"""Build and load the hand-written CUDA kernels of this package.

Each source under ``csrc/`` is compiled by its own ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, all compilers started
together, at first use, and loaded with ``ctypes``. A library lands in
``metatransformer_tpu_torch/_build/`` under a name keyed by a hash of its
source, the shared headers and the flags, so a changed source builds anew
and an unchanged one is reused; beside it, the assembler's report of each
kernel's registers, shared memory and spills (``-Xptxas -v``). There is no
fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import types
from pathlib import Path
from typing import Dict

_CSRC = Path(__file__).resolve().parent / "csrc"
# every header under csrc/ is part of every library's key
_HEADERS = (_CSRC / "common.cuh", _CSRC / "wgmma.cuh", _CSRC / "gemm_sm90.cuh")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _int, _float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ll = ctypes.c_longlong
# source -> {exported function: argument types}; every function returns int.
_SOURCES = {
    _CSRC / "fused_block.cu": {
        # x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, bias, xn, qkv, o, out,
        # B, T, D, H, eps, stream
        "mt_attn_sublayer": [_vp] * 12 + [_int] * 4 + [_float, _vp],
        # x, ln_s, ln_b, w1, b1, w2, b2, xn, h, out, rows, D, F, eps, stream
        "mt_mlp_sublayer": [_vp] * 10 + [_int] * 3 + [_float, _vp],
        # qkv, bias, o, B, T, D, H, stream: the attention core alone (card tests)
        "mt_attn_core": [_vp] * 3 + [_int] * 4 + [_vp],
    },
    _CSRC / "fused_block_bwd.cu": {
        # x, g, ln_s, ln_b, wqkv, bqkv, wproj, bias, dx, dqkv, xn, o, dgamma,
        # dbeta, qkv, d_o, dxn, stats, row_stats, partial, B, T, D, H, eps,
        # stream
        "mt_attn_sublayer_bwd": [_vp] * 20 + [_int] * 4 + [_float, _vp],
        "mt_ln_grad_chunks": [_int],
        # A, B, bias, res, C, M, N, K, trans_b, epi, stream: the GEMM alone (card
        # tests)
        "mt_gemm_sm90": [_vp] * 5 + [_int] * 5 + [_vp],
    },
    _CSRC / "flash_attention_fwd.cu": {
        # the bf16 forward on wgmma: q, k, v, bias, o, lse, B, T, H, hd, q/k/v
        # strides (b, t, h), scale, is_fp32 (0), stream
        "mt_flash_fwd": [_vp] * 6 + [_int] * 4 + [_ll] * 3 + [_float, _int, _vp],
    },
    _CSRC / "flash_attention.cu": {
        # the fp32 route; arguments as mt_flash_fwd, mt_flash_bwd_dq and
        # mt_flash_bwd_dkv with is_fp32 = 1
        "mt_flash_fwd_f32": [_vp] * 6 + [_int] * 4 + [_ll] * 3 + [_float, _int, _vp],
        "mt_flash_bwd_dq_f32": [_vp] * 8 + [_int] * 4 + [_ll] * 6 + [_float, _int, _vp],
        "mt_flash_bwd_dkv_f32": [_vp] * 9 + [_int] * 4 + [_ll] * 6 + [_float, _int, _vp],
    },
    _CSRC / "flash_attention_bwd.cu": {
        # the bf16 backward on wgmma: q, k, v, bias, d_o, lse, delta, dq, B, T,
        # H, hd, q/k/v strides, dq strides, scale, is_fp32 (0), stream
        "mt_flash_bwd_dq": [_vp] * 8 + [_int] * 4 + [_ll] * 6 + [_float, _int, _vp],
        # as mt_flash_bwd_dq with the outputs dk, dv (shared strides)
        "mt_flash_bwd_dkv": [_vp] * 9 + [_int] * 4 + [_ll] * 6 + [_float, _int, _vp],
    },
    _CSRC / "point_ops.cu": {
        # points, point strides (b, n, c), min_scratch, out, B, N, G, and the
        # launch plan: cluster (0: the device-memory route), threads, points a
        # thread; stream
        "mt_fps": [_vp] + [_ll] * 3 + [_vp] * 2 + [_int] * 6 + [_vp],
    },
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_paths() -> Dict[Path, Path]:
    """source -> the keyed library built from it."""
    common = hashlib.sha256(" ".join(FLAGS).encode())
    for header in _HEADERS:
        common.update(header.read_bytes())
    paths = {}
    for src in _SOURCES:
        digest = common.copy()
        digest.update(src.read_bytes())
        paths[src] = BUILD_DIR / f"libmt_{src.stem}_{digest.hexdigest()[:16]}.so"
    return paths


def build() -> Dict[Path, Path]:
    """Compile every source whose keyed library is missing, one nvcc each,
    all running at once; return source -> library."""
    paths = library_paths()
    missing = {src: so for src, so in paths.items() if not so.exists()}
    if not missing:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for src, so in missing.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [nvcc, *FLAGS, "-o", tmp, str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running.append((src, so, tmp, proc))
    errors = []
    for src, so, tmp, proc in running:
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed ({proc.returncode}) on {src.name}:\n{out}\n{err}")
        else:
            _report_path(so).write_text(err)
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def _report_path(so: Path) -> Path:
    return so.with_suffix(".ptxas.txt")


def ptxas_report(source: str) -> str:
    """What the assembler said of each kernel of ``csrc/<source>`` when its
    library was built (registers, shared memory, spills): the ``-Xptxas -v``
    lines."""
    path = _report_path(library_paths()[_CSRC / source])
    return path.read_text() if path.exists() else ""


@functools.lru_cache(maxsize=1)
def library() -> types.SimpleNamespace:
    """The kernels' C functions by name, built and loaded at first use."""
    fns = types.SimpleNamespace()
    for src, so in build().items():
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SOURCES[src].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(fns, name, fn)
        lib.mt_error_string.argtypes = [ctypes.c_int]
        lib.mt_error_string.restype = ctypes.c_char_p
        fns.mt_error_string = lib.mt_error_string
    return fns
