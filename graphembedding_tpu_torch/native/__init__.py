"""Struc2Vec's C++ host pipeline (ctypes bindings), built at first use.

`graphnative.cpp` (carried over from the JAX package's native library) holds
the BFS ring degree lists and the cumulative DTW distances of node pairs
(`struc2vec_distances`), and the exact and fastdtw distances of two
sequences (`dtw`, `fastdtw`). `library()` compiles it with g++ into
`graphembedding_tpu_torch/build/` under a name keyed by a hash of the
source and the flags, so an edited source is rebuilt and an unchanged one
is built once; the build happens at first use, never at import. A missing
g++ or a failed build raises: nothing falls back to the Python pipeline.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "graphnative.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
# the JAX package's flags: the same code generation (FMA contraction
# included) gives the same distances bit for bit on one machine
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-pthread",
             "-std=c++17"]

_P, _I32, _I64, _F64 = (ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                        ctypes.c_double)
# name -> (restype, argtypes) of each C entry point
SIGNATURES = {
    # a, len(a), b, len(b), opt1 -> exact DTW
    "dtw_rle": (_F64, [_P, _I64, _P, _I64, _I32]),
    # a, len(a), b, len(b), radius -> fastdtw over RLE pairs
    "fastdtw_rle": (_F64, [_P, _I64, _P, _I64, _I64]),
    # row_ptr, col_idx, V, pair u, pair v, n_pairs, max_layers, out_dist,
    # out_nlayers, n_threads, dtw_mode (0 exact, 1 fastdtw r=1), early_stop
    "struc2vec_distances": (None, [_P, _P, _I64, _P, _P, _I64, _I64, _P, _P,
                                   _I64, _I32, _F64]),
}


def library_path():
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libgraphnative_{h.hexdigest()[:16]}.so")


def build():
    """Compile the source unless the library for its hash exists. Returns
    the library's path."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: the struc2vec native "
                           "library of graphembedding_tpu_torch cannot be "
                           "built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build in a temporary directory, then rename: a concurrent process
    # never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, "lib.so")
        run = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", lib],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"g++ failed on graphnative.cpp "
                               f"({run.returncode}):\n{run.stdout}"
                               f"{run.stderr}")
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded native library, built on first call."""
    lib = ctypes.CDLL(build())
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _f64(a):
    return np.ascontiguousarray(a, dtype=np.float64)


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def struc2vec_distances(row_ptr, col_idx, pairs_u, pairs_v, max_layers,
                        workers=1, dtw_mode="fastdtw", early_stop=35.0):
    """Cumulative struc2vec DTW distances of (u, v) node pairs.

    The CSR must be the symmetrized adjacency. Returns (dist [n_pairs,
    max_layers] float64, -1 past a pair's layers; n_layers [n_pairs]
    int64). `workers`: threads for the per-root BFS and per-pair DTW loops
    (0 -> all hardware threads); the result does not depend on it.
    `dtw_mode`: 'fastdtw' (radius 1, what the reference computes) or
    'exact'. `early_stop`: a pair's layer loop stops once its cumulative
    distance reaches it (0 disables).
    """
    if dtw_mode not in ("fastdtw", "exact"):
        raise ValueError(f"dtw_mode must be 'fastdtw' or 'exact', got "
                         f"{dtw_mode!r}")
    if not workers:
        workers = os.cpu_count() or 1
    rp, ci, pu, pv = (_i64(a) for a in (row_ptr, col_idx, pairs_u, pairs_v))
    V = rp.shape[0] - 1
    n_pairs = pu.shape[0]
    if pv.shape[0] != n_pairs or ci.shape[0] != int(rp[-1]):
        raise ValueError("struc2vec_distances: pairs_u/pairs_v lengths or "
                         "the CSR's sizes disagree")
    for ids in (ci, pu, pv):
        if ids.size and (ids.min() < 0 or ids.max() >= V):
            raise ValueError("struc2vec_distances: a node id outside "
                             f"[0, {V})")
    dist = np.full((n_pairs, max_layers), -1.0, dtype=np.float64)
    nlay = np.zeros(n_pairs, dtype=np.int64)
    library().struc2vec_distances(
        rp.ctypes.data, ci.ctypes.data, V, pu.ctypes.data, pv.ctypes.data,
        n_pairs, int(max_layers), dist.ctypes.data, nlay.ctypes.data,
        int(workers), 1 if dtw_mode == "fastdtw" else 0, float(early_stop))
    return dist, nlay


def fastdtw(seq_a, seq_b, radius=1) -> float:
    """fastdtw over flattened (degree, count) pairs, the struc2vec cost."""
    a, b = _f64(seq_a), _f64(seq_b)
    return float(library().fastdtw_rle(a.ctypes.data, a.shape[0],
                                       b.ctypes.data, b.shape[0],
                                       int(radius)))


def dtw(seq_a, seq_b, opt1=True) -> float:
    """Exact DTW with the struc2vec cost: flattened (degree, count) pairs
    when opt1, else plain degree sequences."""
    a, b = _f64(seq_a), _f64(seq_b)
    return float(library().dtw_rle(a.ctypes.data, a.shape[0], b.ctypes.data,
                                   b.shape[0], 1 if opt1 else 0))
