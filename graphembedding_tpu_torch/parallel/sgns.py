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

A chunk's steps, the replica syncs among them, run through
`train.chunk_graph.run_chunk` on buffers (the token blocks gathered into
[S, G, PL], the learning rates as a float32 tensor): over NCCL one CUDA
graph a chunk, over gloo with CUDA tensors the steps one by one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from graphembedding_tpu_torch.ops.sgns import sgns_block_grads_plain
from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.parallel.rowshard import offset_blocks
from graphembedding_tpu_torch.train.chunk_graph import run_chunk
from graphembedding_tpu_torch.train.skipgram import (
    KERNELS,
    PLAIN,
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


def synced(b, s, tables, data, sync_every, n_steps, step):
    """step(), a chunk's step s on its buffers b, with its replicas' syncs:
    step 0 first keeps the bases ("base/<name>" of each name in `tables`);
    the replicas are synced after every `sync_every`-th step and once more
    after the last, so they agree. Returns step()'s outputs."""
    if s == 0:
        for k in tables:
            b[f"base/{k}"] = b[k].clone()
    out = step()
    syncs = int((s + 1) % sync_every == 0) + int(s + 1 == n_steps)
    for _ in range(syncs):
        sync_replicas([b[k] for k in tables], [b[f"base/{k}"]
                                               for k in tables], data)
    return out


def _chunk_step(b, s, ops, *, data, model, nsp, neg_w, update_cap,
                sync_every, n_steps):
    """Step s of a chunk on its buffers (`chunk_graph.run_chunk`), then
    its replica syncs."""
    if model is not None:  # K1 fuses the dot product with the sigmoid
        ops = ops._replace(grads=functools.partial(
            sgns_block_grads_plain,
            reduce=functools.partial(comm.all_reduce, group=model)))
    return synced(b, s, ("w_cat",), data, sync_every, n_steps, lambda: (
        sgns_step(b["w_cat"], b["tokens"][s], b["eff"][s], b["negs"][s],
                  b["lrs"][s], window_ok=b["window_ok"], dm=b["dm"],
                  nsp=nsp, neg_w=neg_w, update_cap=update_cap, ops=ops)))


def sharded_sgns_chunk(w_cat, walks, eff, negs, alpha, min_alpha, t0,
                       total_steps, *, mesh, block_walks, window, negative,
                       neg_share_packs=4, update_cap=8.0, sync_every=None,
                       ops=KERNELS):
    """S = eff.shape[0] dp SGNS steps on this rank's replica.

    w_cat [V, 2*Dl]: this rank's columns of (w_in | w_out), Dl = D / tp
    (updated in place); eff [S, G, PL] the window draws (the same on every
    rank), negs [S, G2, K] this data rank's negative ids. Returns (w_cat,
    losses [S] averaged over the data ranks, pairs [S] summed over them).

    Over NCCL the S steps through the kernels replay one captured CUDA
    graph (`chunk_graph.run_chunk`); over gloo with CUDA tensors, on the
    CPU, or through the plain versions (`ops=PLAIN`), they are launched
    one by one.
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
    window_ok, dm = window_geometry(L, geo.PL, window, walks.device)
    lrs = torch.as_tensor(step_lrs(t0, S, alpha, min_alpha, total_steps),
                          device=walks.device)
    tokens = offset_blocks(
        walks, dp_offsets(t0, S, geo, block_walks, n, di), geo)
    inputs = dict(tokens=tokens, eff=eff, negs=negs, lrs=lrs,
                  window_ok=window_ok, dm=dm)
    tp = mesh.size("model") > 1
    consts = dict(data=data, model=model if tp else None, nsp=geo.nsp,
                  neg_w=float(np.float32(negative) / np.float32(K)),
                  update_cap=float(update_cap),
                  sync_every=min(sync_every or DEFAULT_SYNC_EVERY, S),
                  n_steps=S)
    with f32_matmul():
        losses, pairs = run_chunk(
            _chunk_step, S, {"w_cat": w_cat}, inputs, ops=ops, plain=PLAIN,
            consts=consts, groups=(data, model) if tp else (data,))
    stats = comm.all_reduce(torch.stack([losses, pairs]), data)
    return w_cat, stats[0] / n, stats[1]
