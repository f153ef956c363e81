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
the model-axis sum as its `reduce`, and the dense form of the cap whatever
`HSTrainer(cap_mode=)` says: the JAX package's `sharded_hs_chunk` takes no
`sparse_cap` either. The window draws `eff` differ by data
rank: the JAX body folds their key by the data index. A chunk's steps and
syncs run through `train.chunk_graph.run_chunk` as the dp SGNS chunk's do
(over NCCL one CUDA graph a chunk; `points` and `codes` constant inputs).
"""

from __future__ import annotations

import functools

import torch

from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.parallel.rowshard import offset_blocks
from graphembedding_tpu_torch.parallel.sgns import (
    DEFAULT_SYNC_EVERY,
    dp_geometry,
    dp_offsets,
    synced,
)
from graphembedding_tpu_torch.train.chunk_graph import run_chunk
from graphembedding_tpu_torch.train.hsoftmax import KERNELS, PLAIN, hs_step
from graphembedding_tpu_torch.train.skipgram import step_lrs, window_geometry
from graphembedding_tpu_torch.utils.precision import f32_matmul


def _chunk_step(b, s, ops, *, data, model, update_cap, sync_every,
                n_steps):
    """Step s of a chunk on its buffers (`chunk_graph.run_chunk`), then
    its replica syncs."""
    reduce = (None if model is None else
              functools.partial(comm.all_reduce, group=model))
    return synced(b, s, ("w_in", "w_tree"), data, sync_every, n_steps,
                  lambda: hs_step(
                      b["w_in"], b["w_tree"], b["tokens"][s], b["eff"][s],
                      b["points"], b["codes"], b["lrs"][s],
                      window_ok=b["window_ok"], dm=b["dm"],
                      update_cap=update_cap, ops=ops, reduce=reduce))


def sharded_hs_chunk(w_in, w_tree, walks, points, codes, eff, alpha,
                     min_alpha, t0, total_steps, *, mesh, block_walks,
                     window, update_cap=8.0, sync_every=None, ops=KERNELS):
    """S = eff.shape[0] HS steps on this rank's replicas.

    w_in [V, Dl], w_tree [n_inner, Dl]: this rank's columns (updated in
    place); eff [S, G, PL] this data rank's window draws. Returns (w_in,
    w_tree, losses [S] averaged over the data ranks, pairs [S] summed over
    them).

    Over NCCL the S steps through the kernels replay one captured CUDA
    graph (`chunk_graph.run_chunk`); over gloo with CUDA tensors, on the
    CPU, or through the plain versions (`ops=PLAIN`), they are launched
    one by one.
    """
    data, model = mesh.get_group("data"), mesh.get_group("model")
    n, di = mesh.size("data"), mesh.get_local_rank("data")
    NW, L = walks.shape
    geo = dp_geometry(NW, L, block_walks, n, 1)
    S = eff.shape[0]
    if tuple(eff.shape) != (S, geo.G, geo.PL):
        raise ValueError(f"draws eff {tuple(eff.shape)} do not match {geo}")
    window_ok, dm = window_geometry(L, geo.PL, window, walks.device)
    lrs = torch.as_tensor(step_lrs(t0, S, alpha, min_alpha, total_steps),
                          device=walks.device)
    tokens = offset_blocks(
        walks, dp_offsets(t0, S, geo, block_walks, n, di), geo)
    inputs = dict(tokens=tokens, eff=eff, points=points, codes=codes,
                  lrs=lrs, window_ok=window_ok, dm=dm)
    tp = mesh.size("model") > 1
    consts = dict(data=data, model=model if tp else None,
                  update_cap=float(update_cap),
                  sync_every=min(sync_every or DEFAULT_SYNC_EVERY, S),
                  n_steps=S)
    with f32_matmul():
        losses, pairs = run_chunk(
            _chunk_step, S, {"w_in": w_in, "w_tree": w_tree}, inputs,
            ops=ops, plain=PLAIN, consts=consts,
            groups=(data, model) if tp else (data,))
    stats = comm.all_reduce(torch.stack([losses, pairs]), data)
    return w_in, w_tree, stats[0] / n, stats[1]
