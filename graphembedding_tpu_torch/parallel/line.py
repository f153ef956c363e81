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
"""

from __future__ import annotations

import torch

from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.parallel.sgns import (
    DEFAULT_SYNC_EVERY,
    sync_replicas,
)


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


def sharded_line_chunk(emb, ctx, hs, tposs, tnegs, lrs, *, mesh, negative,
                       k_shared=0, update_cap=8.0, sync_every=None,
                       ops=None):
    """S = hs.shape[0] LINE steps on this rank's replicas, on its draws
    (`models.line.line_bulk_samples` at the local batch). emb, ctx as in
    `line_step` (ctx None for order 'first'), updated in place. Returns
    (emb, ctx, losses [S] averaged over the data ranks)."""
    from graphembedding_tpu_torch.models.line import KERNELS, line_step

    local_batch(mesh, hs.shape[1] * mesh.size("data"))
    group, n = mesh.get_group("data"), mesh.size("data")
    S = hs.shape[0]
    sync_every = min(sync_every or DEFAULT_SYNC_EVERY, S)
    tables = [emb] if ctx is None else [emb, ctx]
    bases = [t.clone() for t in tables]
    losses = []
    for s in range(S):
        losses.append(line_step(emb, ctx, hs[s], tposs[s], tnegs[s], lrs[s],
                                negative=negative, k_shared=k_shared,
                                update_cap=update_cap, ops=ops or KERNELS))
        if (s + 1) % sync_every == 0:
            sync_replicas(tables, bases, group)
    sync_replicas(tables, bases, group)  # so the replicas agree
    return emb, ctx, comm.all_reduce(torch.stack(losses), group) / n
