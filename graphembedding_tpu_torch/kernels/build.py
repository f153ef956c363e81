"""Build and load the CUDA kernels of `graphembedding_tpu_torch/csrc/`.

The sources are compiled with `nvcc` for Hopper (`sm_90a`), one process a
source, all started together, and linked into one shared library with a
plain C interface, loaded with `ctypes`. The library goes to
`graphembedding_tpu_torch/build/` under a name keyed by a hash of the
sources and the compiler flags, so an edited source is rebuilt and an
unchanged one is built once. The build happens at first use, never at
import. A missing `nvcc` or a failed build raises: there is no fallback.

Every C entry point takes its pointers and the CUDA stream as `void*` and
returns the `cudaError_t` of its launch; `check` raises on a non-zero one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

from graphembedding_tpu_torch.utils.profiling import span

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _I64, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
# name -> argtypes of each C entry point (restype is int: cudaError_t,
# except where RESTYPES says otherwise)
SIGNATURES = {
    # device, yin, ld_yin, yout, ld_yout, vn, ld_vn, mask, neg_ok,
    # d_yin, d_yout, d_vn, loss, G, G2, PL, D, K, neg_w, smem, stream
    "ge_sgns_block_grads": [_I, _P, _I64, _P, _I64, _P, _I64, _P, _P,
                            _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # device, table, ld, V, ids, N, C, out, stream
    "ge_gather_rows": [_I, _P, _I64, _I, _P, _I, _I, _P, _P],
    # device, table, ld, V, ids, grads, N, C, scratch, stream
    "ge_scatter_add_rows": [_I, _P, _I64, _I, _P, _P, _I, _I, _P, _P],
    # N, V -> int32 elements of K2's scratch (returns int64)
    "ge_scatter_add_rows_scratch": [_I, _I],
    # device, table, ld, V, ids, grads, N, C, scratch, group, stream
    "ge_scatter_add_small": [_I, _P, _I64, _I, _P, _P, _I, _I, _P, _I, _P],
    # N, V -> int32 elements of K4's group-plan scratch (returns int64)
    "ge_scatter_add_small_scratch": [_I, _I],
    # device, table, V, ids, N, W, B, stages, grid, smem, out, stream
    "ge_dma_gather_rows": [_I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # device, row_ptr, col, degree, accept, alias, E, starts, B, L, draws,
    # seed, out, stream (accept null: uniform)
    "ge_walk_first_order": [_I, _P, _P, _P, _P, _P, _I64, _P, _I64, _I, _P,
                            _P, _P, _P],
    # device, degree, nbr, nbr_w, D, starts, B, L, inv_p, inv_q, draws,
    # seed, out, stream
    "ge_walk_exact_pq": [_I, _P, _P, _P, _I, _P, _I64, _I, _F, _F, _P, _P,
                         _P, _P],
    # device, row_ptr, col, degree, accept, alias, E, edge_weight, wsum,
    # nbr, D, starts, B, L, P, R, flags, a_coef, beta, acc_prev,
    # acc_shared, acc_other, draws, seed, out, stream
    "ge_walk_rejection_pq": [_I, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _I,
                             _P, _I64, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                             _P, _P, _P, _P],
    # device, deg, first, p_up, can_up, cols, acc, ali, V, K*E, starts, B,
    # L, max_moves, stay_prob, draws, seed, out, stream
    "ge_walk_multilayer": [_I, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _P,
                           _I64, _I, _I, _F, _P, _P, _P, _P],
    # device, w_in, ld_in, w_tree, ld_tree, tok, eff, points, codes,
    # window_ok, dm, d_yin, d_tree, parts, G, PL, D, T, vec, smem, stream
    "ge_hs_block_grads": [_I, _P, _I64, _P, _I64, _P, _P, _P, _P, _P, _P,
                          _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "ge_error_string": [_I],
    # device: once a process and device, before a capture (`prepare`)
    "ge_prepare_sgns": [_I],
    "ge_prepare_rows": [_I],
    "ge_prepare_small": [_I],
    "ge_prepare_hs": [_I],
}

RESTYPES = {"ge_error_string": ctypes.c_char_p,
            "ge_scatter_add_rows_scratch": _I64,
            "ge_scatter_add_small_scratch": _I64}

# what the last build took and printed (ptxas register / spill report)
build_log = {"seconds": None, "ptxas": ""}


def sources():
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC)
        if f.endswith((".cu", ".cuh"))
    )


def _nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        nvcc = cand if os.path.exists(cand) else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or CUDA_HOME/bin): the CUDA kernels of "
            "graphembedding_tpu_torch cannot be built")
    return nvcc


def library_path():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libge_kernels_{h.hexdigest()[:16]}.so")


def build():
    """Compile the sources unless the library for their hash exists.
    Returns the library's path."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    cu = [p for p in sources() if p.endswith(".cu")]
    t0 = time.perf_counter()
    # build in a temporary directory, then rename: a concurrent process
    # never loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(p) + ".o") for p in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"nvcc failed on {os.path.basename(src)} "
                  f"({p.returncode}):\n{log}"
                  for src, p, log in zip(cu, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        link = subprocess.run(
            [nvcc, NVCC_FLAGS[0], NVCC_FLAGS[1], "-shared", "-o", lib,
             *objs], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(lib, out)
    build_log.update(seconds=time.perf_counter() - t0, ptxas="".join(logs))
    return out


def _bind(lib, names):
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = RESTYPES.get(name, _I)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    with span("kernels.load"):
        return _bind(ctypes.CDLL(build()), SIGNATURES)


def build_text(src, subdir, tag):
    """Compile one CUDA source text (a benchmark's variant of a kernel)
    into a library of its own under BUILD_DIR/subdir, keyed by its hash,
    unless it exists. Returns (the loaded library, with the entry points
    of SIGNATURES that it has bound, nvcc's output)."""
    key = hashlib.sha256((" ".join(NVCC_FLAGS) + src).encode())
    out_dir = os.path.join(BUILD_DIR, subdir)
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{tag}_{key.hexdigest()[:16]}.so")
    log = lib[:-3] + ".log"
    if not os.path.exists(lib):
        cu = lib[:-3] + ".cu"
        with open(cu, "w") as f:
            f.write(src)
        out = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", lib,
                              cu], capture_output=True, text=True)
        if out.returncode:
            raise RuntimeError(f"nvcc failed on {tag}:\n{out.stdout}"
                               f"{out.stderr}")
        with open(log, "w") as f:
            f.write(out.stdout + out.stderr)
    dll = ctypes.CDLL(lib)
    with open(log) as f:
        return _bind(dll, [n for n in SIGNATURES if hasattr(dll, n)]), f.read()


@functools.lru_cache(maxsize=None)
def prepare(device_index: int) -> None:
    """Make every kernel of a training step ready to be captured in a CUDA
    graph on this card, once a process: each loaded, its shared memory
    opted into and its resident blocks an SM read, so that a launch makes
    no host API call but the launch itself. Launches nothing."""
    lib = library()
    for name in ("ge_prepare_sgns", "ge_prepare_rows", "ge_prepare_small",
                 "ge_prepare_hs"):
        check(getattr(lib, name)(device_index), name)


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().ge_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
