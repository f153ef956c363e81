"""SDNE's sparse products: the port's row-wise SpMM against cuSPARSE.

At the products `SDNE.train_sparse` makes (the first layer A @ W1 and its
gradient A^T @ g with D = 256, the Laplacian term A_sym @ Y with D = 128)
on the Wiki-scale graph and on `synthetic_wiki(num_nodes=100_000,
avg_degree=10.0)`: device ms a call of `ops.spmm.csr_rows_matmul` (the
port's form, `torch.segment_reduce` over each row in CSR order) and of
cuSPARSE's SpMM (`A @ X` on the same CSR tensor, which the port does not
call), in turns; whether five calls of each on the same inputs give the
same bits; their largest difference; and the bound: the larger of the
bytes (the CSR's values, columns and row offsets, X and the output, each
once) over 3.35 TB/s and 2 * nnz * D FLOP over 67 TFLOP/s of float32.
One JSON line a product, with the card's name and power limit.

    python -m graphembedding_tpu_torch.benchmarks.spmm_bench

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json

import torch

from graphembedding_tpu_torch.benchmarks.common import require_card, turns_ms
from graphembedding_tpu_torch.ops.spmm import (
    adjacency,
    csr_from_edges,
    csr_rows_matmul,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
F32_FLOP_PER_S = 67e12  # H100 SXM, float32 outside the tensor cores


def identical(fn, calls=5):
    first = fn()
    return all(torch.equal(first, fn()) for _ in range(calls - 1))


def measure(name, A, D, dev, card):
    V, nnz = A.shape[0], A.values().numel()
    gen = torch.Generator(device=dev).manual_seed(0)
    X = torch.randn((V, D), generator=gen, device=dev)
    ours, lib = (lambda: csr_rows_matmul(A, X)), (lambda: A @ X)
    ms, lib_ms = turns_ms(ours, lib)
    nbytes = 4 * nnz + 8 * (nnz + V + 1) + 2 * 4 * V * D
    bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                         2 * nnz * D / F32_FLOP_PER_S)
    rec = {"product": name, "V": V, "nnz": nnz, "D": D, "ms": ms,
           "cusparse_ms": lib_ms, "bound_ms": bound_ms,
           "identical_run_to_run": identical(ours),
           "cusparse_identical_run_to_run": identical(lib),
           "max_abs_diff": float((ours() - lib()).abs().max()),
           "card": card}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    """Measure every product; returns their records."""
    from graphembedding_tpu_torch.data import load_dataset, synthetic_wiki

    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(
        argv)
    dev, card = require_card()
    records = []
    for gname, g in (("wiki", load_dataset("wiki").graph),
                     ("100k", synthetic_wiki(num_nodes=100_000,
                                             avg_degree=10.0).graph)):
        src, dst, w = g.edges()
        for name, M, D in (
                (f"{gname} A @ W1",
                 csr_from_edges(src, dst, w, g.num_nodes, dev), 256),
                (f"{gname} A^T @ g",
                 csr_from_edges(dst, src, w, g.num_nodes, dev), 256),
                (f"{gname} A_sym @ Y", adjacency(g, sym=True, device=dev),
                 128)):
            records.append(measure(name, M, D, dev, card))
    return records


if __name__ == "__main__":
    main()
