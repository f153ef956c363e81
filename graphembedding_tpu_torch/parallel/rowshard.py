"""Row-sharded SGNS: one global table, its rows split over the data axis.

Counterpart of `graphembedding_tpu/parallel/rowshard.py`. Rank r of the
data axis owns rows [r*Vp, (r+1)*Vp) of the fused [n*Vp, 2D] table, so a
table larger than one card spreads over the mesh, and every step is an
exact synchronous update of the one global table: at world size 1 it is the
single-device step bit for bit.

A step, on each rank, for its own slice of the walk block:

- ids: the step's token ids (-1 pads) and negative ids, `all_gather`ed once
  (`gather_ids`); the fetch and both pushes reuse them;
- fetch (`fetch_rows_with`): each owner gathers the rows it owns for every
  requester with K3 (`ops.rows.gather_rows`) on clipped local ids and zeroes
  the rest; `all_to_all_single` sends each requester its block from every
  owner, and the requester selects its row from the owner's block by
  id // Vp. The JAX package sums over owners (`psum_scatter`); each row has
  one owner, so the select gives the same rows. A pad comes back as a zero
  row (the single-device step reads row 0 there): either way the masks give
  it exactly zero weight in every product;
- gradients: K1 (`ops.sgns.sgns_block_grads`) on the rank's block, the
  masks as `train.skipgram.step_masks` builds them;
- push (`push_grads_with`): the gradient rows, occupancy riding as their
  last column, are `all_gather`ed, and each owner scatter-adds the rows it
  owns with the step's `scatter_add` (K2); ids it does not own become -1,
  which K2 drops. Pads are -1 everywhere, and the owner of global row 0 adds
  every rank's pad count to row 0's occupancy, as the JAX step's scatter of
  pads onto row 0 does. The cap min(1, cap / R) is then applied over the
  shard densely (`train.skipgram.capped_update`), with R the occupancy
  summed over all ranks.

Launches a step: K3 once, K1 once, K2 twice. `prefetch=True` fetches step
t+1's rows before step t's push lands (one step of row staleness; the JAX
package's double-buffered halo, `SkipGramConfig.rowshard_prefetch`).

A chunk's steps run through `train.chunk_graph.run_chunk` on buffers: the
token blocks gathered into [S, G, PL], the draws, the learning rates as a
float32 tensor and the table. Over NCCL a chunk replays one CUDA graph
(the JAX package's one `jit(shard_map(... lax.scan ...))`), the
exchanges inside it; over gloo with CUDA tensors the exchanges go through
host memory, and the steps run one by one.
"""

from __future__ import annotations

import numpy as np
import torch

from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.train.chunk_graph import run_chunk
from graphembedding_tpu_torch.train.skipgram import (
    KERNELS,
    PLAIN,
    block_geometry,
    capped_update,
    event_rows,
    step_lrs,
    step_masks,
    window_geometry,
)


def gather_ids(ids, lo, Vp, group):
    """all_gather the ids [T] (-1 pads) of every rank once.

    Returns (local [n, T], owned [n, T]) in this owner's numbering: local =
    id - lo, owned where 0 <= local < Vp (pads are owned by no rank).
    """
    local = comm.all_gather(ids, group) - lo
    return local, (local >= 0) & (local < Vp)


def fetch_rows_with(w_local, ids, local, owned, group, gather=KERNELS.gather):
    """Rows of the global table for this rank's ids [T], from their owners.

    w_local [Vp, C] this rank's rows; (local, owned) from `gather_ids`.
    Returns [T, C]; a pad's row is zeros.
    """
    n, T = local.shape
    Vp, C = w_local.shape
    rows = gather(w_local, local.clamp(0, Vp - 1).reshape(-1)).view(n, T, C)
    rows = torch.where(owned[..., None], rows, 0.0)
    got = comm.all_to_all(rows, group)  # block i: owner i's rows for me
    owner = (ids.clamp(min=0) // Vp).long()
    return got[owner, torch.arange(T, device=ids.device)]


def push_grads_with(Vp, local, owned, grads, group,
                    scatter_add=KERNELS.scatter_add):
    """Sum every rank's gradient rows [T, C] (aligned with the ids given to
    `gather_ids`) into a [Vp, C] buffer of the rows this owner holds."""
    grads_all = comm.all_gather(grads, group)
    flat = torch.where(owned, local, -1).reshape(-1)
    buf = torch.zeros((Vp, grads.shape[1]), dtype=grads.dtype,
                      device=grads.device)
    return scatter_add(buf, flat, grads_all.reshape(-1, grads.shape[1]))


def rank_geometry(NW, L, block_walks, n, neg_share_packs):
    """The packing of one rank's slice of a block (the JAX chunk body's):
    the requested block clamped to the corpus and split over n ranks,
    rounded down to whole packing groups; `n_blocks` counts global blocks
    of n * Bw walks."""
    if NW < n:
        raise ValueError(f"walk corpus ({NW}) smaller than data axis ({n})")
    geo = block_geometry(NW, L, max(min(block_walks, NW) // n, 1),
                         neg_share_packs)
    return geo._replace(n_blocks=max(NW // (n * geo.Bw), 1))


def block_offsets(t0, S, geo, n, di):
    """First walk of rank di's slice at steps t0 .. t0+S-1: blocks stride
    by the n * Bw walks the ranks actually train, so no walk is skipped."""
    steps = t0 + np.arange(S)
    return (steps % geo.n_blocks) * n * geo.Bw + di * geo.Bw


def offset_blocks(walks, offs, geo):
    """The token blocks walks[o : o + Bw] for o in offs, packed as
    [len(offs), G, PL]; one gather."""
    idx = torch.as_tensor(offs, device=walks.device)[:, None] + \
        torch.arange(geo.Bw, device=walks.device)
    return walks[idx].view(len(offs), geo.G, geo.PL)


def _fetched(b, s, ops, group, lo, Vp):
    """Step s's token block, its ids (tokens then negatives) as
    `gather_ids` numbers them, and their rows from the owners."""
    tok = b["tokens"][s]
    ids = torch.cat([tok.reshape(-1), b["negs"][s].reshape(-1)])
    local, owned = gather_ids(ids, lo, Vp, group)
    rows = fetch_rows_with(b["w_local"], ids, local, owned, group,
                           ops.gather)
    return tok, local, owned, rows


def _chunk_step(b, s, ops, *, group, lo, Vp, nsp, neg_w, update_cap,
                prefetch, n_steps):
    """Step s of a chunk on its buffers (`chunk_graph.run_chunk`): its
    rows (under prefetch, those step s - 1 fetched before its push), under
    prefetch step s + 1's rows, then the step. Returns the loss summed
    over the block, the pairs clamped to 1, and the pairs."""
    w_local = b["w_local"]
    C = w_local.shape[1]
    D = C // 2
    tok, local, owned, rows = (b.pop("next") if prefetch and s else
                               _fetched(b, s, ops, group, lo, Vp))
    if prefetch and s + 1 < n_steps:  # before step s's push lands
        b["next"] = _fetched(b, s + 1, ops, group, lo, Vp)
    G, PL = tok.shape
    negs = b["negs"][s]
    G2, K = negs.shape
    Tt = G * PL
    _, mask, neg_ok = step_masks(tok, b["eff"][s], negs, b["window_ok"],
                                 b["dm"], nsp)
    y = rows[:Tt].view(G, PL, C)
    vn = rows[Tt:, D:].view(G2, K, D)
    d_yin, d_yout, d_vn, loss_g = ops.grads(
        y[..., :D], y[..., D:], vn, mask, neg_ok, neg_w)
    d_tok, d_neg = event_rows(d_yin, d_yout, d_vn, mask, neg_w)
    tbuf = push_grads_with(Vp, local[:, :Tt], owned[:, :Tt], d_tok, group,
                           ops.scatter_add)
    if lo == 0:  # every rank's pads, as the JAX scatter's row 0
        tbuf[0, C] += (local[:, :Tt] < 0).sum()
    nbuf = push_grads_with(Vp, local[:, Tt:], owned[:, Tt:], d_neg, group,
                           ops.scatter_add)
    capped_update(w_local, tbuf, nbuf, b["lrs"][s], update_cap)
    pairs = mask.sum()
    return loss_g.sum(), pairs.clamp(min=1.0), pairs


def rowsharded_sgns_chunk(w_local, walks, eff, negs, alpha, min_alpha, t0,
                          total_steps, *, mesh, block_walks, window,
                          negative, neg_share_packs=4, update_cap=8.0,
                          prefetch=False, ops=KERNELS):
    """S = eff.shape[0] row-sharded SGNS steps on this rank.

    w_local [Vp, 2D]: this rank's rows of the global table (updated in
    place); walks [NW, L]: the corpus, the same on every rank; eff
    [S, G, PL] and negs [S, G2, K]: this rank's draws (the JAX body folds
    both by rank). Returns (w_local, losses [S], pairs [S]): the loss
    summed over ranks over the pairs summed over ranks (each rank's at
    least 1), and the global pair counts.

    Over NCCL the S steps through the kernels replay one captured CUDA
    graph (`chunk_graph.run_chunk`); over gloo with CUDA tensors, on the
    CPU, or through the plain versions (`ops=PLAIN`), they are launched
    one by one.
    """
    group = mesh.get_group("data")
    n, di = mesh.size("data"), mesh.get_local_rank("data")
    NW, L = walks.shape
    Vp = w_local.shape[0]
    geo = rank_geometry(NW, L, block_walks, n, neg_share_packs)
    S, K = eff.shape[0], negs.shape[2]
    if tuple(eff.shape) != (S, geo.G, geo.PL) or tuple(negs.shape) != (
            S, geo.G2, K):
        raise ValueError(f"draws eff {tuple(eff.shape)} / negs "
                         f"{tuple(negs.shape)} do not match {geo}")
    window_ok, dm = window_geometry(L, geo.PL, window, walks.device)
    lrs = torch.as_tensor(step_lrs(t0, S, alpha, min_alpha, total_steps),
                          device=walks.device)
    tokens = offset_blocks(walks, block_offsets(t0, S, geo, n, di), geo)
    inputs = dict(tokens=tokens, eff=eff, negs=negs, lrs=lrs,
                  window_ok=window_ok, dm=dm)
    consts = dict(group=group, lo=di * Vp, Vp=Vp, nsp=geo.nsp,
                  neg_w=float(np.float32(negative) / np.float32(K)),
                  update_cap=float(update_cap), prefetch=bool(prefetch),
                  n_steps=S)
    loss_sum, pairs_min1, pairs = run_chunk(
        _chunk_step, S, {"w_local": w_local}, inputs, ops=ops, plain=PLAIN,
        consts=consts, groups=(group,))
    stats = comm.all_reduce(torch.stack([loss_sum, pairs_min1, pairs], 1),
                            group)
    return w_local, stats[:, 0] / stats[:, 1], stats[:, 2]
