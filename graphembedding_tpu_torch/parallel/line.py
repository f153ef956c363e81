"""Data-parallel LINE: each rank samples its own share of every edge batch.

Counterpart of `graphembedding_tpu/parallel/line.py`. The global batch is
split over the data axis; each rank draws its batch_size // n edges and
negatives from a stream of its own (the JAX body folds its key by rank),
runs the single-device `models.line.line_step` (K3 gathers, K4 or K2
scatters) on its table replicas, and every `sync_every` steps (default 4)
and at the chunk's end the replicas' deltas since the last sync are summed
(`parallel.sgns.sync_replicas`). The JAX package measured averaging instead
at micro-F1 0.375 against 0.77: LINE's row updates are sparse, and an
average divides each by the data-axis size.

No model axis: LINE's tables are [V, D <= 256], so column slices buy
nothing, and a mesh with model > 1 is refused.

A chunk's steps and syncs run through `train.chunk_graph.run_chunk` on
the chunk's draws (`lrs` a float32 tensor): over NCCL one CUDA graph a
chunk, over gloo with CUDA tensors the steps one by one.
"""

from __future__ import annotations

from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.parallel.sgns import DEFAULT_SYNC_EVERY, synced
from graphembedding_tpu_torch.train.chunk_graph import run_chunk


def local_batch(mesh, batch_size):
    """Each data rank's share of the global batch; refuses a mesh with a
    model axis and a batch the data axis does not divide."""
    if mesh.size("model") != 1:
        raise ValueError(
            "LINE shards over the data axis only; use a (n, 1) mesh")
    n = mesh.size("data")
    if batch_size // n == 0:
        raise ValueError("batch_size must be >= data-axis size")
    if batch_size % n:
        raise ValueError(f"batch_size ({batch_size}) must divide evenly "
                         f"across the data axis ({n} ranks)")
    return batch_size // n


def _chunk_step(b, s, ops, *, data, negative, k_shared, update_cap,
                sync_every, n_steps):
    """Step s of a chunk on its buffers (`chunk_graph.run_chunk`), then
    its replica syncs."""
    from graphembedding_tpu_torch.models.line import line_step

    return synced(
        b, s, ("emb",) if "ctx" not in b else ("emb", "ctx"), data,
        sync_every, n_steps, lambda: (line_step(
            b["emb"], b.get("ctx"), b["hs"][s], b["tposs"][s],
            b["tnegs"][s], b["lrs"][s], negative=negative,
            k_shared=k_shared, update_cap=update_cap, ops=ops),))


def sharded_line_chunk(emb, ctx, hs, tposs, tnegs, lrs, *, mesh, negative,
                       k_shared=0, update_cap=8.0, sync_every=None,
                       ops=None):
    """S = hs.shape[0] LINE steps on this rank's replicas, on its draws
    (`models.line.line_bulk_samples` at the local batch). emb, ctx as in
    `line_step` (ctx None for order 'first'), updated in place. Returns
    (emb, ctx, losses [S] averaged over the data ranks).

    Over NCCL the S steps through the kernels replay one captured CUDA
    graph (`chunk_graph.run_chunk`); over gloo with CUDA tensors, on the
    CPU, or through the plain versions, they are launched one by one."""
    from graphembedding_tpu_torch.models.line import KERNELS, PLAIN

    local_batch(mesh, hs.shape[1] * mesh.size("data"))
    group, n = mesh.get_group("data"), mesh.size("data")
    S = hs.shape[0]
    tables = {"emb": emb} if ctx is None else {"emb": emb, "ctx": ctx}
    consts = dict(data=group, negative=negative, k_shared=k_shared,
                  update_cap=update_cap,
                  sync_every=min(sync_every or DEFAULT_SYNC_EVERY, S),
                  n_steps=S)
    losses, = run_chunk(_chunk_step, S, tables,
                        dict(hs=hs, tposs=tposs, tnegs=tnegs, lrs=lrs),
                        ops=ops or KERNELS, plain=PLAIN, consts=consts,
                        groups=(group,))
    return emb, ctx, comm.all_reduce(losses, group) / n
