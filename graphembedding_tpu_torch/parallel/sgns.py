"""Data-parallel SGNS ('dp'): table replicas over the data axis, columns over
the model axis.

Counterpart of `graphembedding_tpu/parallel/sgns.py`:

- data axis (hogwild-style): each rank trains its own slice of every walk
  block on its own replica; every `sync_every` steps (default 4) and at the
  end of the chunk the replicas' deltas since the last sync are summed,
  `w = w_base + all_reduce(w - w_base)`. Summed, not averaged: an average
  divides each sparse row's update by the data-axis size (parallel/line.py
  in the JAX package measured LINE at micro-F1 0.375 against 0.77 so);
- model axis (exact): each rank holds a column slice [V, 2*D/tp] of the
  fused table. The logits need the full dot product, so each rank computes
  its partial logits and an `all_reduce` over `model` completes them before
  the sigmoid; the gradient products then use the full logits with the
  local columns. K1 fuses the dot product with the sigmoid and cannot take
  a partial sum, so this mode runs K1's plain function
  (`ops.sgns.sgns_block_grads_plain` with the reduce) in full float32, as
  the JAX package computes it with einsums outside Pallas; the row gathers
  (K3) and scatters (K2) stay kernels.

At model size 1 a step is the single-device `train.skipgram.sgns_step`
(K3, K1, K2). The window draws `eff` are shared by the data ranks; only the
negatives differ by rank (the JAX body folds only the negatives' key).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from graphembedding_tpu_torch.ops.sgns import sgns_block_grads_plain
from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.train.skipgram import (
    KERNELS,
    block_geometry,
    sgns_step,
    step_lrs,
    window_geometry,
)
from graphembedding_tpu_torch.utils.precision import f32_matmul

# steps between replica syncs: on the JAX package's 120-node community test,
# once a 64-step chunk gave micro-F1 0.54, every 4 or every step 0.98
DEFAULT_SYNC_EVERY = 4


def dp_geometry(NW, L, block_walks, n, neg_share_packs):
    """The packing of one rank's slice (block_walks // n walks, rounded to
    whole groups) and the global block count NW // block_walks."""
    if block_walks // n == 0:
        raise ValueError("block_walks must be >= data-axis size")
    geo = block_geometry(NW, L, block_walks // n, neg_share_packs)
    return geo._replace(n_blocks=max(NW // block_walks, 1))


def dp_offsets(t0, S, geo, block_walks, n, di):
    """First walk of rank di's slice at steps t0 .. t0+S-1: global blocks
    of block_walks walks, rank di starting at di * (block_walks // n)."""
    steps = t0 + np.arange(S)
    return (steps % geo.n_blocks) * block_walks + di * (block_walks // n)


def sync_replicas(tables, bases, group):
    """tables[i] = bases[i] + the sum over the group of (tables[i] -
    bases[i]), then bases[i] = tables[i]; in place."""
    for w, b in zip(tables, bases):
        w.copy_(b + comm.all_reduce(w - b, group))
        b.copy_(w)


def sharded_sgns_chunk(w_cat, walks, eff, negs, alpha, min_alpha, t0,
                       total_steps, *, mesh, block_walks, window, negative,
                       neg_share_packs=4, update_cap=8.0, sync_every=None,
                       ops=KERNELS):
    """S = eff.shape[0] dp SGNS steps on this rank's replica.

    w_cat [V, 2*Dl]: this rank's columns of (w_in | w_out), Dl = D / tp
    (updated in place); eff [S, G, PL] the window draws (the same on every
    rank), negs [S, G2, K] this data rank's negative ids. Returns (w_cat,
    losses [S] averaged over the data ranks, pairs [S] summed over them).
    """
    data, model = mesh.get_group("data"), mesh.get_group("model")
    n, di = mesh.size("data"), mesh.get_local_rank("data")
    NW, L = walks.shape
    geo = dp_geometry(NW, L, block_walks, n, neg_share_packs)
    S, K = eff.shape[0], negs.shape[2]
    if tuple(eff.shape) != (S, geo.G, geo.PL) or tuple(negs.shape) != (
            S, geo.G2, K):
        raise ValueError(f"draws eff {tuple(eff.shape)} / negs "
                         f"{tuple(negs.shape)} do not match {geo}")
    sync_every = min(sync_every or DEFAULT_SYNC_EVERY, S)
    if mesh.size("model") > 1:
        ops = ops._replace(grads=functools.partial(
            sgns_block_grads_plain,
            reduce=functools.partial(comm.all_reduce, group=model)))
    window_ok, dm = window_geometry(L, geo.PL, window, walks.device)
    lrs = step_lrs(t0, S, alpha, min_alpha, total_steps)
    offs = dp_offsets(t0, S, geo, block_walks, n, di)
    neg_w = float(np.float32(negative) / np.float32(K))
    w_base = w_cat.clone()
    losses, pairs = [], []
    with f32_matmul():
        for s in range(S):
            tok = walks[offs[s]: offs[s] + geo.Bw].reshape(geo.G, geo.PL)
            loss, p = sgns_step(
                w_cat, tok, eff[s], negs[s], float(lrs[s]),
                window_ok=window_ok, dm=dm, nsp=geo.nsp, neg_w=neg_w,
                update_cap=float(update_cap), ops=ops)
            losses.append(loss)
            pairs.append(p)
            if (s + 1) % sync_every == 0:
                sync_replicas([w_cat], [w_base], data)
    sync_replicas([w_cat], [w_base], data)  # so the replicas agree
    stats = comm.all_reduce(torch.stack([torch.stack(losses),
                                         torch.stack(pairs)]), data)
    return w_cat, stats[0] / n, stats[1]
