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


def all_gather_rows(y, mesh):
    return _AllGatherRows.apply(y, mesh.get_group("data"),
                                mesh.get_local_rank("data"))


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


def mesh_adam_step(net, opt, loss_fn, mesh):
    """One Adam step (`opt`, a `train.adam.Adam` on net's parameters) on
    the data-axis sum of loss_fn()'s local loss: the gradients all_reduced
    in one flat buffer. Launched step by step (an exchange through gloo
    cannot be captured into a CUDA graph). Returns the summed loss."""
    group = mesh.get_group("data")
    loss_l = loss_fn()
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss_l, params)
    flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
    summed, off = {}, 0
    for k, p in zip(names, params):
        summed[k] = flat[off:off + p.numel()].view_as(p)
        off += p.numel()
    opt.step(summed)
    return comm.all_reduce(loss_l.detach(), group)


def sharded_sdne_train(net, opt, a_rows, l_rows, ok, *, mesh, num_nodes,
                       alpha, beta, nu1, nu2, n_epochs):
    """n_epochs full-batch Adam steps on this rank's rows: a_rows [Vl, V]
    and l_rows [Vl, Vp] (`pad_rows`, sliced), ok [Vl]. Returns the summed
    losses, a list of 0-d tensors."""
    from graphembedding_tpu_torch.models.sdne import weight_penalty

    n, V = data_axis(mesh), num_nodes

    def loss_local():
        y = net.encode(a_rows)
        a_hat = net.decode(y)
        b_ = torch.where(a_rows != 0, beta, 1.0)
        l2nd = (((a_rows - a_hat) * b_).square().sum(-1) * ok).sum() / V
        y_full = all_gather_rows(y, mesh)
        l1st = alpha * 2.0 * (y * (l_rows @ y_full)).sum() / V
        return l2nd + l1st + weight_penalty(net, nu1, nu2) / n

    return [mesh_adam_step(net, opt, loss_local, mesh)
            for _ in range(n_epochs)]


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


def sharded_sdne_sparse_train(net, opt, inputs, *, mesh, num_nodes, alpha,
                              beta, nu1, nu2, n_epochs, row_chunk):
    """n_epochs Adam steps of `train_sparse`'s objective on this rank's
    rows (`pad_sparse_inputs`): the first layer as this rank's SpMM, the
    reconstruction in checkpointed chunks of its real rows, the Laplacian
    term as sum_i d_i |y_i|^2 - sum_i <y_i, (A_sym Y)_i> over its rows.
    Returns the summed losses, a list of 0-d tensors."""
    from graphembedding_tpu_torch.models.sdne import (
        chunk_reconstruction,
        run_stack,
        weight_penalty,
    )

    A, At, S, St, deg_w, nbr, nbr_w = inputs
    n, V = data_axis(mesh), num_nodes
    real = nbr.shape[0]

    def loss_local():
        first = net.enc[0]
        y = run_stack(net.enc[1:], torch.relu(spmm(A, first.w, At)
                                              + first.b))
        y_full = all_gather_rows(y, mesh)
        l1st = alpha * 2.0 * ((deg_w[:, None] * y.square()).sum()
                              - (y * spmm(S, y_full, St)).sum()) / V
        l2nd = 0.0
        for lo in range(0, real, row_chunk):
            hi = min(lo + row_chunk, real)
            l2nd = l2nd + checkpoint(
                chunk_reconstruction, net, y[lo:hi], nbr[lo:hi],
                nbr_w[lo:hi], beta, use_reentrant=False,
                preserve_rng_state=False)
        return l2nd / V + l1st + weight_penalty(net, nu1, nu2) / n

    return [mesh_adam_step(net, opt, loss_local, mesh)
            for _ in range(n_epochs)]


def shard_dense(A, L, mesh, num_nodes):
    """This rank's rows of the padded A and L, and their row mask."""
    A_pad, L_pad, ok = pad_rows(A, L, num_nodes, data_axis(mesh))
    lo, hi, _ = local_rows(mesh, num_nodes)
    return A_pad[lo:hi], L_pad[lo:hi], ok[lo:hi]

