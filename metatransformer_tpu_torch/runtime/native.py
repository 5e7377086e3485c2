"""ctypes bindings for the C++ host runtime (grid subsampling, kNN).

Port of ``metatransformer_tpu/runtime/native.py``. The reference ships its
host-side point processing as C++; this package keeps its own copy of the two
sources under ``runtime/native/`` and builds them with ``g++`` at first use
into ``metatransformer_tpu_torch/_build/``, under a name keyed by a hash of
the sources and flags. They run on the host, in the input pipeline, on numpy
arrays; nothing here touches the card.

A missing compiler or a failed build raises: :func:`grid_subsample` and
:func:`knn_search` never fall back. Their numpy versions stay as named plain
functions (:func:`grid_subsample_plain`, :func:`knn_search_plain`) for the
tests to hold the C++ against.
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
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent / "native"
_SOURCES = (_NATIVE_DIR / "grid_subsample.cpp", _NATIVE_DIR / "knn.cpp")
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    for src in _SOURCES:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmt_native_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the two sources into one shared library unless its keyed
    file is there already; return its path."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host runtime cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [cxx, *FLAGS, "-o", tmp, *map(str, _SOURCES)],
        capture_output=True, text=True, timeout=300,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The host runtime, built and loaded at first use."""
    lib = ctypes.CDLL(str(build()))
    lib.grid_subsample.restype = ctypes.c_int
    lib.grid_subsample.argtypes = [
        _f32p, ctypes.c_int64, _f32p, ctypes.c_int64, ctypes.c_float, _f32p, _f32p, _i64p,
    ]
    lib.knn_search.restype = ctypes.c_int
    lib.knn_search.argtypes = [
        _f32p, ctypes.c_int64, _f32p, ctypes.c_int64, ctypes.c_int64, _i64p, _f32p,
    ]
    return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def _cloud(points, what: str) -> np.ndarray:
    points = np.ascontiguousarray(points, np.float32)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"{what} must be [N, 3], got {points.shape}")
    return points


def _features(features, n: int) -> np.ndarray:
    if features is None:
        return np.zeros((n, 0), np.float32)
    features = np.ascontiguousarray(features, np.float32)
    if features.ndim != 2 or len(features) != n:
        raise ValueError(f"features must be [{n}, C], got {features.shape}")
    return features


def grid_subsample(
    points: np.ndarray, features: Optional[np.ndarray] = None, dl: float = 0.1
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Voxel-grid average subsampling. points [N, 3] -> [M, 3] (M <= N),
    voxels in first-seen order; features [N, C] are averaged alike."""
    points = _cloud(points, "points")
    n = len(points)
    if n == 0 or not dl > 0:
        raise ValueError(f"grid_subsample needs points and dl > 0, got N={n}, dl={dl}")
    feats = _features(features, n)
    fdim = feats.shape[1]
    out_p = np.empty_like(points)
    out_f = np.empty((n, fdim), np.float32)
    out_n = ctypes.c_int64(0)
    rc = library().grid_subsample(
        _fptr(points), n, _fptr(feats), fdim, ctypes.c_float(dl),
        _fptr(out_p), _fptr(out_f), ctypes.byref(out_n),
    )
    if rc != 0:
        raise RuntimeError(f"grid_subsample failed with code {rc}")
    m = out_n.value
    return out_p[:m].copy(), (out_f[:m].copy() if fdim else None)


def grid_subsample_plain(
    points: np.ndarray, features: Optional[np.ndarray] = None, dl: float = 0.1
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Numpy version of :func:`grid_subsample`: the same voxel averages in
    the same first-seen order."""
    points = _cloud(points, "points")
    feats = _features(features, len(points))
    keys = np.floor(points / dl).astype(np.int64)
    _, first_idx, inv = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    inv = rank[inv.reshape(-1)]
    m = len(first_idx)
    counts = np.bincount(inv, minlength=m).astype(np.float32)

    def average(values):
        out = np.zeros((m, values.shape[1]), np.float32)
        for d in range(values.shape[1]):
            out[:, d] = np.bincount(inv, weights=values[:, d], minlength=m)
        return out / counts[:, None]

    return average(points), (average(feats) if feats.shape[1] else None)


def knn_search(
    support: np.ndarray, queries: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """k nearest support points per query -> (idx [M, k] int64, d2 [M, k])."""
    support, queries = _cloud(support, "support"), _cloud(queries, "queries")
    n, m = len(support), len(queries)
    if m == 0 or not 0 < k <= n:
        raise ValueError(f"knn_search needs queries and k in 1..{n}, got M={m}, k={k}")
    out_i = np.empty((m, k), np.int64)
    out_d = np.empty((m, k), np.float32)
    rc = library().knn_search(
        _fptr(support), n, _fptr(queries), m, k, out_i.ctypes.data_as(_i64p), _fptr(out_d),
    )
    if rc != 0:
        raise RuntimeError(f"knn_search failed with code {rc}")
    return out_i, out_d


def knn_search_plain(
    support: np.ndarray, queries: np.ndarray, k: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy version of :func:`knn_search`: brute force over all pairs."""
    support, queries = _cloud(support, "support"), _cloud(queries, "queries")
    d2 = (
        np.sum(queries**2, 1)[:, None]
        + np.sum(support**2, 1)[None]
        - 2.0 * queries @ support.T
    )
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return idx.astype(np.int64), np.take_along_axis(d2, idx, 1).astype(np.float32)
