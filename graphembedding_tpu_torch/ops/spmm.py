"""Sparse products over the graph adjacency: SpMM, SDDMM and the
Laplacian quadratic form.

Counterpart of `graphembedding_tpu/ops/spmm.py`, which keeps the
adjacency as a BCOO matrix. Here it is a `torch.sparse_csr_tensor`, with
duplicate entries summed as BCOO and scipy's COO sum them. No TPU kernel
lies under either: the JAX package's products are XLA's, and these are
PyTorch's.

The product sums each output row's entries in CSR order
(`torch.segment_reduce` over w_e * X[col_e]), so it gives the same bits
from run to run on the card. cuSPARSE's SpMM (`A @ X` for a CSR A) does
not on the H100: two calls on the same inputs differ in the last bits
(`benchmarks/spmm_bench.py`), which would break SDNE's run-to-run
identity.

The Laplacian term of SDNE is never built as a matrix:

    tr(Y^T L Y) = sum_i d_i ||y_i||^2 - sum_{(i,j)} w_ij <y_i, y_j>

The JAX package takes the edge sum as an SDDMM over the edge list. Here it
is `sum(Y * (A_sym @ Y))`, the same function, because its gradient is
then the row-wise SpMM, where the backward of the SDDMM's row gathers
would scatter with float atomics.

Products run in the caller's float32 matmul precision; the SDNE trainers
set it to "highest" (no TF32), and TF32 would change their results.
"""

from __future__ import annotations

import numpy as np
import torch


def _sym(graph):
    """Host (src, dst, w) of the symmetrized adjacency, as in the
    reference's `_create_A_L` (A_ = A + A^T with duplicate sum).
    Undirected graphs already list both directions in edges(); adding the
    transpose again would double every weight."""
    src, dst, w = graph.edges()
    if graph.directed:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
        w = np.concatenate([w, w])
    return src, dst, np.asarray(w, dtype=np.float32)


def csr_from_edges(src, dst, w, num_nodes, device, num_cols=None):
    """[num_nodes, num_cols (default num_nodes)] CSR with A[src_e, dst_e] +=
    w_e on `device`, duplicates summed: built on the CPU from a coalesced
    COO, then moved."""
    idx = torch.from_numpy(np.stack([src, dst]).astype(np.int64))
    coo = torch.sparse_coo_tensor(
        idx, torch.from_numpy(np.asarray(w, dtype=np.float32)),
        (num_nodes, num_cols or num_nodes),
        check_invariants=True).coalesce()
    return coo.to_sparse_csr().to(device)


def adjacency(graph, sym: bool = False, device="cuda"):
    """The graph's adjacency as a CSR tensor (optionally symmetrized:
    A + A^T for a directed graph; an undirected graph already lists both
    directions)."""
    src, dst, w = _sym(graph) if sym else graph.edges()
    return csr_from_edges(src, dst, w, graph.num_nodes, device)


def csr_row_sums(A):
    """Row sums of a CSR A as a dense vector, each row summed in CSR
    order (0 for an empty row)."""
    return torch.segment_reduce(A.values(), "sum",
                                offsets=A.crow_indices(), axis=0)


def csr_rows_matmul(A, X):
    """A @ X for a CSR A [V, V] and a dense X [V, D]: output row i sums
    w_e * X[col_e] over row i's entries, in CSR order (0 for an empty
    row)."""
    return torch.segment_reduce(A.values()[:, None] * X[A.col_indices()],
                                "sum", offsets=A.crow_indices(), axis=0)


class _SpMM(torch.autograd.Function):
    """A @ X with the gradient At @ g for X (A and At constants)."""

    @staticmethod
    def forward(ctx, A, At, X):
        ctx.At = At
        return csr_rows_matmul(A, X)

    @staticmethod
    def backward(ctx, g):
        return None, None, csr_rows_matmul(ctx.At, g)


def spmm(A, X, At):
    """Sparse [V, V] A times dense [V, D] X -> dense [V, D].

    At, A's transpose as CSR, carries the gradient to X as the same
    row-wise product (no transpose a step); for a symmetric A pass A.
    """
    return _SpMM.apply(A, At, X)


def sddmm(src, dst, Y):
    """Sampled dense-dense matmul: <y_src_e, y_dst_e> per edge."""
    return (Y[src] * Y[dst]).sum(-1)


def laplacian_quadratic(A_sym, deg_w, Y):
    """tr(Y^T L Y) with L = D - A_sym, WITHOUT materializing L.

    A_sym: the symmetrized adjacency as CSR (`adjacency(graph, sym=True)`);
    deg_w: its row sums (`csr_row_sums`). The edge term is sum(Y * (A_sym @
    Y)), which equals the JAX package's sum_e w_e * sddmm(src, dst, Y).
    """
    row_term = (deg_w[:, None] * Y.square()).sum()
    edge_term = (Y * spmm(A_sym, Y, A_sym)).sum()
    return row_term - edge_term


def sym_edges(graph, device="cuda"):
    """(src, dst, w, deg_w) of the symmetrized adjacency on `device`, as
    the JAX package's `sym_edges` gives them (deg_w summed in edge
    order)."""
    src, dst, w = _sym(graph)
    deg_w = np.zeros(graph.num_nodes, np.float32)
    np.add.at(deg_w, src, w)
    return tuple(torch.as_tensor(a, device=device) for a in (
        src.astype(np.int64), dst.astype(np.int64), w, deg_w))
