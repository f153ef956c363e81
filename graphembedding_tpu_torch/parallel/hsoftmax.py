"""Data- and tensor-parallel hierarchical softmax over the mesh.

Counterpart of `graphembedding_tpu/parallel/hsoftmax.py`, laid out as the
dp SGNS mode (`parallel/sgns.py`):

- model axis (exact): w_in [V, D/tp] and the inner-node table w_tree
  [V - 1, D/tp] are column-sliced; each rank's partial (center, context,
  level) logits are summed over `model` by `all_reduce` before the sigmoid,
  and the gradient products use the full logits with the local columns;
- data axis (hogwild-style): each rank trains its slice of every walk
  block on its own replicas, whose deltas since the last sync are summed
  every `sync_every` steps (default 4) and at the chunk's end.

A step is the single-device `train.hsoftmax.hs_step` (K3 gathers; K4, or K2
above `ops.rows.SMALL_V_ROWS` rows, by `ops.rows.scatter_add_table`), with
the model-axis sum as its `reduce`. The window draws `eff` differ by data
rank: the JAX body folds their key by the data index.
"""

from __future__ import annotations

import functools

import torch

from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.parallel.sgns import (
    DEFAULT_SYNC_EVERY,
    dp_geometry,
    dp_offsets,
    sync_replicas,
)
from graphembedding_tpu_torch.train.hsoftmax import KERNELS, hs_step
from graphembedding_tpu_torch.train.skipgram import step_lrs, window_geometry
from graphembedding_tpu_torch.utils.precision import f32_matmul


def sharded_hs_chunk(w_in, w_tree, walks, points, codes, eff, alpha,
                     min_alpha, t0, total_steps, *, mesh, block_walks,
                     window, update_cap=8.0, sync_every=None, ops=KERNELS):
    """S = eff.shape[0] HS steps on this rank's replicas.

    w_in [V, Dl], w_tree [n_inner, Dl]: this rank's columns (updated in
    place); eff [S, G, PL] this data rank's window draws. Returns (w_in,
    w_tree, losses [S] averaged over the data ranks, pairs [S] summed over
    them).
    """
    data, model = mesh.get_group("data"), mesh.get_group("model")
    n, di = mesh.size("data"), mesh.get_local_rank("data")
    NW, L = walks.shape
    geo = dp_geometry(NW, L, block_walks, n, 1)
    S = eff.shape[0]
    if tuple(eff.shape) != (S, geo.G, geo.PL):
        raise ValueError(f"draws eff {tuple(eff.shape)} do not match {geo}")
    sync_every = min(sync_every or DEFAULT_SYNC_EVERY, S)
    reduce = (functools.partial(comm.all_reduce, group=model)
              if mesh.size("model") > 1 else None)
    window_ok, dm = window_geometry(L, geo.PL, window, walks.device)
    lrs = step_lrs(t0, S, alpha, min_alpha, total_steps)
    offs = dp_offsets(t0, S, geo, block_walks, n, di)
    tables = [w_in, w_tree]
    bases = [w_in.clone(), w_tree.clone()]
    losses, pairs = [], []
    with f32_matmul():
        for s in range(S):
            tok = walks[offs[s]: offs[s] + geo.Bw].reshape(geo.G, geo.PL)
            loss, p = hs_step(w_in, w_tree, tok, eff[s], points, codes,
                              float(lrs[s]), window_ok=window_ok, dm=dm,
                              update_cap=float(update_cap), ops=ops,
                              reduce=reduce)
            losses.append(loss)
            pairs.append(p)
            if (s + 1) % sync_every == 0:
                sync_replicas(tables, bases, data)
    sync_replicas(tables, bases, data)  # so the replicas agree
    stats = comm.all_reduce(torch.stack([torch.stack(losses),
                                         torch.stack(pairs)]), data)
    return w_in, w_tree, stats[0] / n, stats[1]
