"""Row-sharded SDNE: exact data parallelism over the adjacency's rows.

Counterpart of `graphembedding_tpu/parallel/sdne.py`. The autoencoder's
parameters are replicated and its gradients summed over the data axis every
step, so a sharded run computes the single-device full-batch objective and
updates (up to the order of float32 sums):

- each rank holds Vp / n rows of A (and of L, or of the symmetrized
  adjacency) and encodes and decodes only those;
- the Laplacian term tr(Y^T L Y) = sum_i <y_i, (L Y)_i> needs every row's
  embedding: the [Vp, d] Y is assembled by `all_gather` (`all_gather_rows`,
  whose backward sums every rank's cotangent and keeps this rank's rows, so
  autograd gives the exact global gradient), and each rank contracts its
  own rows of L;
- the weight penalty is divided by the axis size, so the summed gradient
  counts it once.

Rows are zero-padded to a multiple of the axis size, and a row mask keeps
the pads out of the reconstruction. No kernel of the port runs here: the
products are cuBLAS calls and the sparse ones `ops.spmm`'s row-wise sums.

A train's epochs between checkpoints run as one chunk of Adam steps
(`models.sdne.adam_chunk`, with the data group as its `group`): each step
takes this rank's loss and its gradients by `torch.autograd.grad` on
leaves aliasing the chunk's buffers, sums the gradients over the axis in
one flat buffer and applies Adam in place with the step's bias
corrections. Over NCCL the chunk replays one CUDA graph, the all-gather
of Y and its backward's sum inside it; over gloo with CUDA tensors the
steps run one by one.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from graphembedding_tpu_torch.ops.spmm import (
    _sym,
    csr_from_edges,
    csr_row_sums,
    spmm,
)
from graphembedding_tpu_torch.parallel import comm


def data_axis(mesh):
    """The data axis' size; refuses a mesh with a model axis."""
    if mesh.size("model") != 1:
        raise ValueError(
            "SDNE shards over the data axis only; use a (n, 1) mesh")
    return mesh.size("data")


class _AllGatherRows(torch.autograd.Function):
    """[Vl, d] -> [n * Vl, d], ranks' rows in order; the backward sums the
    cotangents over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, y, group, rank):
        ctx.group, ctx.rank, ctx.rows = group, rank, y.shape[0]
        return comm.all_gather(y, group).reshape(-1, y.shape[1])

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.rows
        return comm.all_reduce(g, ctx.group)[lo:lo + ctx.rows], None, None


def all_gather_rows(y, group, rank):
    """[Vl, d] rows of every rank of `group` as [n * Vl, d], this rank's
    at `rank`; the backward sums the cotangents over the ranks and keeps
    this rank's rows."""
    return _AllGatherRows.apply(y, group, rank)


def pad_rows(A, L, num_nodes, n):
    """A [V, V] -> [Vp, V], L -> [Vp, Vp], and the row mask ok [Vp], with
    Vp the next multiple of n."""
    V = num_nodes
    pad = -(-V // n) * n - V
    A_pad = torch.nn.functional.pad(A, (0, 0, 0, pad))
    L_pad = torch.nn.functional.pad(L, (0, pad, 0, pad))
    ok = torch.nn.functional.pad(torch.ones(V, device=A.device), (0, pad))
    return A_pad, L_pad, ok


def local_rows(mesh, num_nodes):
    """(lo, hi, real): this rank's padded rows [lo, hi) and how many of
    them are real rows."""
    n, di = data_axis(mesh), mesh.get_local_rank("data")
    Vl = -(-num_nodes // n)
    lo = di * Vl
    return lo, lo + Vl, max(min(num_nodes - lo, Vl), 0)


def full_batch_objective(net, b, s, *, alpha, beta, nu1, nu2, n, V, group,
                         rank):
    """This rank's part of the full-batch loss on its rows b["A"] [Vl, V],
    b["L"] [Vl, Vp] and row mask b["ok"] [Vl] (`models.sdne.adam_step`
    sums it over `group`)."""
    from graphembedding_tpu_torch.models.sdne import weight_penalty

    a_rows, l_rows = b["A"], b["L"]
    y = net.encode(a_rows)
    a_hat = net.decode(y)
    b_ = torch.where(a_rows != 0, beta, 1.0)
    l2nd = (((a_rows - a_hat) * b_).square().sum(-1) * b["ok"]).sum() / V
    y_full = all_gather_rows(y, group, rank)
    l1st = alpha * 2.0 * (y * (l_rows @ y_full)).sum() / V
    return l2nd + l1st + weight_penalty(net, nu1, nu2) / n


def sharded_sdne_train(opt, a_rows, l_rows, ok, *, mesh, num_nodes, alpha,
                       beta, nu1, nu2, n_epochs):
    """n_epochs full-batch Adam steps (`opt`, a `train.adam.Adam` on the
    parameters) on this rank's rows: a_rows [Vl, V] and l_rows [Vl, Vp]
    (`pad_rows`, sliced), ok [Vl]. Returns the summed losses [n_epochs]."""
    from graphembedding_tpu_torch.models.sdne import adam_chunk

    return adam_chunk(opt, full_batch_objective, n_epochs,
                      {"A": a_rows, "L": l_rows, "ok": ok}, alpha=alpha,
                      beta=beta, nu1=nu1, nu2=nu2, n=data_axis(mesh),
                      V=num_nodes, group=mesh.get_group("data"),
                      rank=mesh.get_local_rank("data"))


SPARSE_INPUTS = ("A", "At", "S", "St")  # the CSRs of `pad_sparse_inputs`


def pad_sparse_inputs(graph, mesh, device):
    """This rank's sparse inputs, never a dense [V, V]: its rows of A as CSR
    [Vl, V] and their transpose [V, Vl], its rows of the symmetrized
    adjacency [Vl, Vp] and their transpose, their row sums, and its rows of
    the padded neighbor ids and weights (pad rows: no entries)."""
    V = graph.num_nodes
    lo, hi, real = local_rows(mesh, V)
    Vl, Vp = hi - lo, (hi - lo) * mesh.size("data")

    def rows_of(src, dst, w, cols):
        keep = (src >= lo) & (src < hi)
        s, d, ww = src[keep] - lo, dst[keep], w[keep]
        return (csr_from_edges(s, d, ww, Vl, device, cols),
                csr_from_edges(d, s, ww, cols, device, Vl))

    A, At = rows_of(*graph.edges(), V)
    S, St = rows_of(*_sym(graph), Vp)
    nbr, nbr_w = (t[lo:lo + real] for t in graph.neighbor_matrix(device))
    return A, At, S, St, csr_row_sums(S), nbr, nbr_w


def sparse_objective(net, b, s, *, alpha, beta, nu1, nu2, n, V, group,
                     rank, row_chunk):
    """This rank's part of `train_sparse`'s loss on its rows
    (`models.sdne.sparse_buffers` of `pad_sparse_inputs`): the first layer as this rank's SpMM, the
    reconstruction in checkpointed chunks of its real rows, the Laplacian
    term as sum_i d_i |y_i|^2 - sum_i <y_i, (A_sym Y)_i> over its rows."""
    from graphembedding_tpu_torch.models.sdne import (
        buffer_csrs,
        chunk_reconstruction,
        run_stack,
        weight_penalty,
    )

    A, At, S, St = buffer_csrs(b, SPARSE_INPUTS)
    deg_w, nbr, nbr_w = b["deg_w"], b["nbr"], b["nbr_w"]
    real = nbr.shape[0]
    first = net.enc[0]
    y = run_stack(net.enc[1:], torch.relu(spmm(A, first.w, At) + first.b))
    y_full = all_gather_rows(y, group, rank)
    l1st = alpha * 2.0 * ((deg_w[:, None] * y.square()).sum()
                          - (y * spmm(S, y_full, St)).sum()) / V
    l2nd = 0.0
    for lo in range(0, real, row_chunk):
        hi = min(lo + row_chunk, real)
        l2nd = l2nd + checkpoint(
            chunk_reconstruction, net, y[lo:hi], nbr[lo:hi], nbr_w[lo:hi],
            beta, use_reentrant=False, preserve_rng_state=False)
    return l2nd / V + l1st + weight_penalty(net, nu1, nu2) / n


def sharded_sdne_sparse_train(opt, inputs, *, mesh, num_nodes, alpha, beta,
                              nu1, nu2, n_epochs, row_chunk):
    """n_epochs Adam steps of `train_sparse`'s objective on this rank's
    rows (`pad_sparse_inputs`; `sparse_objective`). Returns the summed
    losses [n_epochs]."""
    from graphembedding_tpu_torch.models.sdne import (
        adam_chunk,
        sparse_buffers,
    )

    return adam_chunk(opt, sparse_objective, n_epochs,
                      sparse_buffers(inputs, SPARSE_INPUTS), alpha=alpha,
                      beta=beta, nu1=nu1, nu2=nu2, n=data_axis(mesh),
                      V=num_nodes, group=mesh.get_group("data"),
                      rank=mesh.get_local_rank("data"), row_chunk=row_chunk)


def shard_dense(A, L, mesh, num_nodes):
    """This rank's rows of the padded A and L, and their row mask."""
    A_pad, L_pad, ok = pad_rows(A, L, num_nodes, data_axis(mesh))
    lo, hi, _ = local_rows(mesh, num_nodes)
    return A_pad[lo:hi], L_pad[lo:hi], ok[lo:hi]

