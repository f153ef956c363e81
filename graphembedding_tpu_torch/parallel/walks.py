"""Edge-partitioned distributed random walks on torch.distributed.

Counterpart of `graphembedding_tpu/parallel/walks.py`, whose design notes
hold here:

- Vertices are range-partitioned over the data axis: rank s owns ids
  [s*Vp, (s+1)*Vp) and holds only their CSR rows (and alias tables,
  padded neighbor rows or layer CSRs), padded to one size on every rank.
- A walker always lives on the rank that owns its current vertex, so
  every next hop is a local gather. After a hop the walker state is
  routed to the new owner.
- Hub-safe routing (`_route`): one all-gather of the [cap, F] int32 state,
  then each rank compacts the walkers bound for it into its `cap` slots by
  a cumsum rank. A walker is lost only when more than cap = wl * slack
  walkers sit on one rank at once; that count is returned as overflow.
- Crossers only: the batched engine all-gathers only the walkers whose
  hop left their rank (up to `hop_batch` local hops a round, backpressure
  instead of drops); the a2a engines bucket the crossers by destination
  (`bucket_by_dest`) and move them with one exchange a round
  (`ragged_exchange`, through `comm.ragged_all_to_all`: each bucket's
  occupied rows only). That is the frame compression of the JAX package's
  dense [n*(bcap+1), 3] all_to_all frame, kept as `dense_exchange`, which
  the tests hold the ragged form against: bucketing, backpressure and
  placement are unchanged, so the corpus is the same for every bucket cap.
- Each rank records the tokens of the walkers it hosts into a (walk id, t)
  buffer; the buffers are summed over the ranks at the end (each cell is
  written by one rank), so every rank ends with the whole corpus.

Each rank runs its engine eagerly: a `shard_map` body of the JAX package
is the per-rank code here, `lax.all_gather` is `comm.all_gather`, `psum`
`comm.all_reduce`, a `psum_scatter` over owners an all-to-all and a select
by owner (as `parallel/rowshard.py` fetches rows), `lax.all_to_all`
`comm.all_to_all`. The shapes are the JAX package's fixed per-rank shapes
(cap, send_cap, bcap), so every exchange has one size on every rank. The
draws come from a `torch.Generator` a rank on its device, seeded with
`parallel.mesh.rank_seed(seed, data rank)` (the JAX package folds the key
by rank). Host syncs: none in the all-gather engines until the end; one a
round in the batched and a2a engines, where the host reads the global
live count that decides whether another round runs.

The engines are plain PyTorch: they are XLA, not Pallas kernels, in the
JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.ops.alias import alias_draw
from graphembedding_tpu_torch.ops.walk import (
    _gumbel_pick,
    csr_contains,
    rows_contain,
    sorted_rows,
)
from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.parallel.mesh import check_mesh, rank_seed

_PACK = 1 << 16  # the multilayer a2a exchange packs layer * _PACK + t


# --------------------------------------------------------------------------- #
# host-side partitioners (numpy, the JAX package's arrays exactly)
# --------------------------------------------------------------------------- #


def partition_csr(graph, n_shards, edge_arrays=None):
    """Range-partition the CSR by vertex; pad shards to common sizes.

    Returns dict of numpy arrays stacked over shards:
      row_ptr [n, Vp+1] (local offsets), col_idx [n, Emax], degree [n, Vp]
    plus vp (vertices per shard). `edge_arrays`: optional dict name ->
    (array [E], fill) of edge-aligned arrays (alias tables, weights) to
    partition alongside col_idx.
    """
    V = graph.num_nodes
    vp = (V + n_shards - 1) // n_shards
    edge_arrays = edge_arrays or {}
    row_ptrs, degs = [], []
    cols = []
    extra = {name: [] for name in edge_arrays}
    e_max = 1
    for s in range(n_shards):
        lo, hi = min(s * vp, V), min((s + 1) * vp, V)
        rp_global = graph.row_ptr[lo: hi + 1].astype(np.int64)
        if rp_global.size == 0:  # shard owns no vertices (V < n*vp)
            rp_global = graph.row_ptr[-1:].astype(np.int64)
        local_rp = (rp_global - rp_global[0]).astype(np.int32)
        if hi - lo < vp:  # pad the vertex range to vp
            pad = np.full(vp - (hi - lo), local_rp[-1], dtype=np.int32)
            local_rp = np.concatenate([local_rp, pad])
        sl = slice(int(rp_global[0]), int(rp_global[-1]))
        cols.append(graph.col_idx[sl].astype(np.int32))
        for name, (arr, _fill) in edge_arrays.items():
            extra[name].append(np.asarray(arr[sl]))
        row_ptrs.append(local_rp)
        degs.append(np.diff(local_rp).astype(np.int32))
        e_max = max(e_max, cols[-1].shape[0])
    col_p = np.full((n_shards, e_max), -1, dtype=np.int32)
    for s in range(n_shards):
        col_p[s, : cols[s].shape[0]] = cols[s]
    out = {
        "row_ptr": np.stack(row_ptrs),
        "col_idx": col_p,
        "degree": np.stack(degs),
        "vp": vp,
    }
    for name, (arr, fill) in edge_arrays.items():
        buf = np.full((n_shards, e_max), fill, dtype=arr.dtype)
        for s in range(n_shards):
            buf[s, : extra[name][s].shape[0]] = extra[name][s]
        out[name] = buf
    return out


def partition_neighbor_matrix(graph, n_shards):
    """Vertex-range partition of the padded neighbor rows.

    Returns (nbr [n, Vp, Dpad] i32 pad -1, nbr_w [n, Vp, Dpad] f32 pad 0,
    degree [n, Vp] i32, vp, Dpad), from `Graph.neighbor_matrix`. The port's
    rows are max(max_degree, 1) wide: the JAX package's extra columns up to
    a multiple of 128 lanes (a TPU tiling rule) hold only pads.
    """
    V = graph.num_nodes
    vp = (V + n_shards - 1) // n_shards
    nbr, nbr_w = (t.numpy() for t in graph.neighbor_matrix("cpu"))
    dpad = nbr.shape[1]
    nbr_p = np.full((n_shards, vp, dpad), -1, dtype=np.int32)
    w_p = np.zeros((n_shards, vp, dpad), dtype=np.float32)
    deg_p = np.zeros((n_shards, vp), dtype=np.int32)
    for s in range(n_shards):
        lo, hi = min(s * vp, V), min((s + 1) * vp, V)
        nbr_p[s, : hi - lo] = nbr[lo:hi]
        w_p[s, : hi - lo] = nbr_w[lo:hi]
        deg_p[s, : hi - lo] = graph.degree[lo:hi]
    return nbr_p, w_p, deg_p, vp, dpad


def partition_layers(layers, num_nodes, n_shards):
    """Vertex-range partition of a struc2vec layer-CSR stack.

    `layers` is the `models.struc2vec.build_layer_csr` dict (numpy or
    torch): row_ptr [K, V+1], col_idx/accept/alias [K, E], gamma [K, V].
    Returns dict stacked over shards: row_ptr [n, K, Vp+1] (local
    offsets), col_idx/accept/alias [n, K, Emax], gamma [n, K, Vp], vp.
    """
    rp = np.asarray(layers["row_ptr"])
    col = np.asarray(layers["col_idx"])
    acc = np.asarray(layers["accept"])
    ali = np.asarray(layers["alias"])
    gam = np.asarray(layers["gamma"])
    K = rp.shape[0]
    V = num_nodes
    vp = (V + n_shards - 1) // n_shards
    e_max = 1
    parts = []
    for s in range(n_shards):
        lo, hi = min(s * vp, V), min((s + 1) * vp, V)
        rows, cs, accs, alis, gs = [], [], [], [], []
        for k in range(K):
            rg = rp[k, lo: hi + 1].astype(np.int64)
            if rg.size == 0:
                rg = rp[k, -1:].astype(np.int64)
            lrp = (rg - rg[0]).astype(np.int32)
            if hi - lo < vp:
                lrp = np.concatenate(
                    [lrp, np.full(vp - (hi - lo), lrp[-1], np.int32)])
            sl = slice(int(rg[0]), int(rg[-1]))
            rows.append(lrp)
            cs.append(col[k, sl])
            accs.append(acc[k, sl])
            alis.append(ali[k, sl])
            g = np.zeros(vp, np.float32)
            g[: hi - lo] = gam[k, lo:hi]
            gs.append(g)
            e_max = max(e_max, cs[-1].shape[0])
        parts.append((rows, cs, accs, alis, gs))
    out_rp = np.zeros((n_shards, K, vp + 1), np.int32)
    out_c = np.zeros((n_shards, K, e_max), np.int32)
    out_a = np.ones((n_shards, K, e_max), np.float32)
    out_l = np.zeros((n_shards, K, e_max), np.int32)
    out_g = np.zeros((n_shards, K, vp), np.float32)
    for s, (rows, cs, accs, alis, gs) in enumerate(parts):
        for k in range(K):
            out_rp[s, k] = rows[k]
            out_c[s, k, : cs[k].shape[0]] = cs[k]
            out_a[s, k, : accs[k].shape[0]] = accs[k]
            out_l[s, k, : alis[k].shape[0]] = alis[k]
            out_g[s, k] = gs[k]
    return {"row_ptr": out_rp, "col_idx": out_c, "accept": out_a,
            "alias": out_l, "gamma": out_g, "vp": vp}


def locality_order(graph):
    """Locality-preserving vertex permutation (reverse Cuthill-McKee).

    Returns `perm` with perm[new_id] = old_id. Relabeling a graph by this
    order makes neighbors land near each other in id space, so a range
    partition keeps most hops on their rank (fewer rounds for the batched
    and a2a engines).
    """
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    V = graph.num_nodes
    A = sp.csr_matrix(
        (np.ones(graph.col_idx.shape[0], np.int8), graph.col_idx,
         graph.row_ptr), shape=(V, V))
    A = A + A.T  # RCM wants symmetric structure
    return np.asarray(reverse_cuthill_mckee(A), dtype=np.int64)


def relabel_graph(graph, perm):
    """Relabeled copy of `graph` under perm (perm[new_id] = old_id)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    src, dst, w = graph.edges()
    return Graph(inv[src], inv[dst], w, num_nodes=graph.num_nodes,
                 directed=True)


def _group_starts(num_nodes, num_walks, n, vp):
    """Walker start vertices grouped by owner shard, padded with -1:
    ([n, wl] int32, n * wl)."""
    starts_per_shard = []
    for s in range(n):
        lo, hi = s * vp, min((s + 1) * vp, num_nodes)
        ids = np.arange(lo, hi, dtype=np.int32)
        starts_per_shard.append(np.tile(ids, num_walks))
    wl = max(len(x) for x in starts_per_shard)
    starts = np.full((n, wl), -1, dtype=np.int32)
    for s, x in enumerate(starts_per_shard):
        starts[s, : len(x)] = x
    return starts, n * wl


# --------------------------------------------------------------------------- #
# routing primitives
# --------------------------------------------------------------------------- #


def _set_rows(buf, slot, values):
    """buf[slot] = values, where buf's last row is a trash row: only it may
    take duplicate slots (a torch scatter of duplicates has no order)."""
    buf[slot] = values
    return buf[:-1]


def _compact(allw, lo, vp, cap):
    """The receiver half of `_route`, free of collectives: the rows of allw
    [m, F] whose field 0 lies in [lo, lo + vp), in order, into cap slots
    (-1 filled). Returns (fields, overflow)."""
    v = allw[:, 0]
    mine = (v >= lo) & (v < lo + vp)
    rank = mine.cumsum(0) - 1
    ok = mine & (rank < cap)
    slot = torch.where(ok, rank, cap)
    buf = allw.new_full((cap + 1, allw.shape[1]), -1)
    buf = _set_rows(buf, slot, torch.where(ok[:, None], allw, -1))
    overflow = mine.sum() - ok.sum()
    return list(buf.unbind(1)), overflow


def _route(fields, lo, vp, cap, group):
    """Hub-safe walker routing: all-gather the state, then rank-compaction.

    fields: [cap] int32 walker-state tensors, fields[0] the walker's next
    vertex (-1: dead or empty); the receiver derives the destination by a
    range test on it, so no destination column crosses the wire. Returns
    (new_fields, overflow): this rank's compacted [cap] view of the walkers
    bound for it, and the count it had to drop (more than cap at once).
    """
    send = torch.stack(fields, 1)  # [cap, F]
    allw = comm.all_gather(send, group).reshape(-1, len(fields))
    return _compact(allw, lo, vp, cap)


def _fetch_rows_i32(local_rows, ids, lo, vp, group):
    """Halo fetch of int32 rows from their owner ranks.

    local_rows [Vp, W]: this rank's rows; ids [cap]: the global row ids
    this rank needs (-1: a zero row). Every rank's ids are all-gathered,
    each owner indexes the rows it owns (zeros elsewhere), an all-to-all
    sends each requester its block from every owner, and the requester
    selects its row from the block of the owner, id // Vp (the JAX
    package's psum_scatter sums the blocks; each row has one owner). The
    rows are indexed in plain PyTorch: K3 gathers float tables. Returns
    [cap, W] int32.
    """
    local = comm.all_gather(ids, group).long() - lo  # [n, cap]
    owned = (local >= 0) & (local < vp)
    rows = torch.where(owned[..., None],
                       local_rows[local.clamp(0, vp - 1)], 0)
    got = comm.all_to_all(rows, group)  # block i: owner i's rows for me
    owner = ids.long().clamp(min=0) // vp
    return got[owner, torch.arange(ids.shape[0], device=ids.device)]


def _record(out, cur, wid, t):
    """out[wid, t] += cur + 1 for live walkers (out [n_walkers, length]
    int32, in place; t an int or a per-walker tensor). Each (wid, t) cell
    is written once over all ranks, so the integer adds need no order."""
    alive = wid >= 0
    length = out.shape[1]
    cell = torch.where(alive, wid, 0).long() * length + (
        t.long() if torch.is_tensor(t) else t)
    out.view(-1).index_add_(0, cell, torch.where(alive, cur + 1, 0))
    return out


def bucket_by_dest(v, w, t, vp, n, bcap, send_cap=None, method="auto"):
    """Compact crossing walkers into per-destination buckets.

    The collective-free routing math of the crossers-only exchange.
    v, w, t: [cap] int32 walker state; a crosser has w >= 0 and v >= 0
    (v its next vertex, on another rank; non-crossers hold v = -1); its
    destination is v // vp.

    Returns (sbuf [n*bcap, 3], sent [cap] bool): rows [d*bcap, (d+1)*bcap)
    of sbuf are the crossers bound for rank d, in index order, then -1
    rows; `sent` marks the walkers that got a slot. Crossers beyond bcap
    for their destination, or beyond send_cap in total, stay unsent: the
    caller holds them for the next round (backpressure, never a drop).

    method 'cumsum': one masked cumsum over [n, cap]; 'sort': a cumsum
    compaction into send_cap candidate rows, then a stable argsort by
    destination and a rank within each segment (work independent of n).
    'auto' takes 'cumsum' for n <= 32, 'sort' above, as the JAX package.
    """
    cap = v.shape[0]
    dev = v.device
    smax = cap if send_cap is None else min(send_cap, cap)
    if method == "auto":
        method = "cumsum" if n <= 32 else "sort"
    is_x = (w >= 0) & (v >= 0)
    payload3 = torch.stack([v, w, t], 1)
    flat = payload3.new_full((n * bcap + 1, 3), -1)
    if method == "cumsum":
        dest = torch.where(is_x, v.long() // vp, n)
        xr = is_x.cumsum(0) - 1
        under = is_x & (xr < smax)
        m = under[None, :] & (dest[None, :] == torch.arange(
            n, device=dev)[:, None])  # [n, cap]
        r = m.cumsum(1) - 1
        okm = m & (r < bcap)
        slot_m = torch.arange(n, device=dev)[:, None] * bcap + r
        sent = okm.any(0)
        slot = torch.where(sent, torch.where(okm, slot_m, 0).sum(0),
                           n * bcap)
        return _set_rows(flat, slot, torch.where(sent[:, None], payload3,
                                                 -1)), sent
    if method != "sort":
        raise ValueError(f"unknown method {method!r}")
    xr = is_x.cumsum(0) - 1
    ok_c = is_x & (xr < smax)
    cslot = torch.where(ok_c, xr, smax)
    payload0 = torch.cat([payload3, torch.arange(
        cap, dtype=payload3.dtype, device=dev)[:, None]], 1)
    cand = _set_rows(payload3.new_full((smax + 1, 4), -1), cslot,
                     torch.where(ok_c[:, None], payload0, -1))
    dest = torch.where(cand[:, 1] >= 0, cand[:, 0].long() // vp, n)
    order = torch.argsort(dest, stable=True)
    dsorted = dest[order]
    idx = torch.arange(smax, device=dev)
    change = torch.ones(smax, dtype=torch.bool, device=dev)
    change[1:] = dsorted[1:] != dsorted[:-1]
    seg_start = torch.where(change, idx, 0).cummax(0).values
    rank = idx - seg_start
    ok = (dsorted < n) & (rank < bcap)
    slot = torch.where(ok, dsorted * bcap + rank, n * bcap)
    payload = cand[order]
    flat = _set_rows(flat, slot, torch.where(ok[:, None], payload[:, :3],
                                             -1))
    sent = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    sent = _set_rows(sent, torch.where(ok, payload[:, 3].long(), cap), ok)
    return flat, sent


def place_arrivals(cur, wid, t, pend, out, arrivals, length, extra=None,
                   extra_arrivals=None):
    """Place exchanged walkers into this rank's free slots.

    The collective-free receiver half of an exchange round. `arrivals`
    [m, 3] rows are (vertex, walk id, t of the crossing hop), -1 rows are
    padding; every other row belongs to this rank. Arrivals beyond the
    free slots are dropped and counted (the receiver-capacity rule of
    `_route`). The receiving rank records the crossing hop's token into
    `out` (in place). `extra`/`extra_arrivals` put one more per-walker
    int column (the multilayer engine's layer) into the same slots.
    Returns (cur, wid, t, pend, out, overflow), plus the updated `extra`
    when given.
    """
    cap = cur.shape[0]
    v_a, w_a, t_a = arrivals.unbind(1)
    mine = w_a >= 0
    arr_rank = mine.cumsum(0) - 1
    free = wid < 0
    ok_arr = mine & (arr_rank < free.sum())
    overflow = mine.sum() - ok_arr.sum()
    # the index of the k-th free slot: free slot j with free rank k
    # writes j into fidx[k]
    free_rank = free.cumsum(0) - 1
    fidx = torch.full((cap + 1,), cap, dtype=torch.long, device=cur.device)
    fidx = _set_rows(fidx, torch.where(free, free_rank, cap),
                     torch.arange(cap, device=cur.device))
    dslot = torch.where(ok_arr, fidx[arr_rank.clamp(0, cap - 1)], cap)

    def put(col, values, fill):
        buf = torch.cat([col, col.new_full((1,), fill)])
        return _set_rows(buf, dslot, torch.where(ok_arr, values,
                                                 fill).to(col.dtype))

    cur = put(cur, v_a, -1)
    wid = put(wid, w_a, -1)
    t = put(t, t_a + 1, length)
    pend = put(pend, torch.full_like(w_a, -1), -1)
    _record(out, torch.where(ok_arr, v_a, -1), torch.where(ok_arr, w_a, -1),
            t_a.clamp(0, length - 1))
    wid = torch.where(t >= length, -1, wid)  # arrivals that finished
    if extra is not None:
        extra = put(extra, extra_arrivals, 0)
        return cur, wid, t, pend, out, overflow, extra
    return cur, wid, t, pend, out, overflow


def ragged_exchange(frame, live_here, group):
    """One round's exchange of bucketed crossers, occupied rows only.

    frame [n, bcap, 3]: bucket d holds the rows bound for rank d, occupied
    rows first (`bucket_by_dest`). The counts and this rank's live count go
    out in one small all-to-all, the host reads them (the round's one
    sync), and `comm.ragged_all_to_all` sends each bucket's occupied rows.
    Returns (arrivals [m, 3] grouped by source rank, global live count).
    """
    n = frame.shape[0]
    counts = (frame[:, :, 1] >= 0).sum(1)
    live = live_here.reshape(1, 1).expand(n, 1)
    rows, _, extra_in = comm.ragged_all_to_all(frame, counts, group,
                                               extra=live)
    return rows, sum(e[0] for e in extra_in)


def dense_exchange(frame, live_here, group):
    """The JAX package's exchange, the oracle of `ragged_exchange`: every
    bucket in full, each with one more row that carries this rank's live
    count, through one even all-to-all of [n*(bcap+1), 3]. Returns
    (arrivals [n*bcap, 3] with -1 padding rows, global live count)."""
    n, bcap, _ = frame.shape
    live_row = frame.new_full((n, 1, 3), -1)
    live_row[:, 0, 0] = live_here
    recv = comm.all_to_all(torch.cat([frame, live_row], 1), group)
    return recv[:, :bcap].reshape(-1, 3), int(recv[:, bcap, 0].sum())


# --------------------------------------------------------------------------- #
# engines: each returns fn(this rank's shard tensors..., starts [wl],
# generator) for the rank it runs in
# --------------------------------------------------------------------------- #


class _Axis:
    """This rank's place on the mesh's data axis, and the shapes of an
    engine over it."""

    def __init__(self, mesh, n_walkers, slack, vp):
        mesh = check_mesh(mesh)
        self.n = mesh.size("data")
        self.me = mesh.get_local_rank("data")
        self.group = mesh.get_group("data")
        self.wl = n_walkers // self.n
        self.cap = self.wl * slack
        self.vp = vp
        self.lo = self.me * vp

    def walkers(self, starts):
        """(cur, wid) [cap] int32: this rank's starts in the first wl slots,
        then empty (-1) slots; filler starts (-1) are empty."""
        cur = starts.new_full((self.cap,), -1)
        cur[: self.wl] = starts
        wid = torch.arange(self.cap, dtype=torch.int32,
                           device=starts.device) + self.me * self.wl
        return cur, torch.where(cur >= 0, wid, -1)

    def local(self, v):
        """Whether vertices v are this rank's."""
        return (v >= self.lo) & (v < self.lo + self.vp)

    def lv(self, cur, alive):
        """Local row of each walker's vertex (0 where not alive)."""
        return torch.where(alive, cur - self.lo, 0).long()

    def finish(self, out, *counts):
        """The corpus summed over the ranks (minus 1: -1 where no rank
        wrote), and each count summed over the ranks."""
        out = comm.all_reduce(out, self.group) - 1
        tot = comm.all_reduce(torch.stack(
            [c.to(torch.int64).reshape(()) for c in counts]), self.group)
        return (out, *tot.unbind(0))


def _new_out(n_walkers, length, cur, wid):
    out = torch.zeros((n_walkers, length), dtype=torch.int32,
                      device=cur.device)
    return _record(out, cur, wid, 0)


def _uniform_pick(u, deg):
    """A uniform slot in [0, deg) from u in [0, 1), as `ops.walk`'s
    `uniform_walks` takes it (0 where deg is 0)."""
    return torch.minimum((u * deg.to(torch.float32)).to(torch.int64),
                         (deg.to(torch.int64) - 1).clamp(min=0))


class _Csr:
    """One rank's partitioned CSR on its device, with the next-hop draw of
    the first-order engines."""

    def __init__(self, row_ptr, col_idx, degree, accept=None, alias=None):
        self.row_ptr = row_ptr.long()
        self.col = col_idx
        self.degree = degree
        self.accept, self.alias = accept, alias
        self.last = col_idx.shape[0] - 1

    def hop(self, lv, deg, gen):
        """The next vertex of walkers at local rows lv with degree deg:
        one uniform (`uniform_walks`' draw), or two for an alias draw."""
        u1 = torch.rand(lv.shape, generator=gen, device=lv.device)
        rp = self.row_ptr[lv]
        if self.accept is None:
            pick = _uniform_pick(u1, deg)
        else:
            u2 = torch.rand(lv.shape, generator=gen, device=lv.device)
            pick = alias_draw(self.accept, self.alias, rp,
                              deg.clamp(min=1).long(), u1, u2)
        return self.col[(rp + pick).clamp(max=self.last)]


def _make_first_order(mesh, *, length, vp, n_walkers, slack, weighted,
                      route_off=False):
    """First-order walk engine: uniform or weighted-alias next hops.

    Returns fn(row_ptr [Vp+1], col_idx [E], degree [Vp], [accept [E],
    alias [E] when weighted,] starts [wl], generator) -> (walks
    [n_walkers, length] int32, overflow), the same on every rank.

    `route_off=True` is a timing control without meaning: the exchange is
    skipped and walkers are clamped onto their current rank, so the walks
    are wrong but each step's work and shapes are the same.
    """
    ax = _Axis(mesh, n_walkers, slack, vp)

    def fn(row_ptr, col_idx, degree, *rest):
        *alias_t, starts, gen = rest
        csr = _Csr(row_ptr, col_idx, degree, *alias_t)
        cur, wid = ax.walkers(starts)
        out = _new_out(n_walkers, length, cur, wid)
        overflow = torch.zeros((), dtype=torch.int64, device=cur.device)
        for t in range(1, length):
            alive = wid >= 0
            lv = ax.lv(cur, alive)
            deg = torch.where(alive, degree[lv], 0)
            nxt = csr.hop(lv, deg, gen)
            nxt = torch.where(alive & (deg > 0), nxt, -1)
            wid = torch.where(nxt >= 0, wid, -1)
            if route_off:
                cur = torch.where(wid >= 0,
                                  (nxt - ax.lo).clamp(0, vp - 1) + ax.lo, -1)
            else:
                (cur, wid), ov = _route([nxt, wid], ax.lo, vp, ax.cap,
                                        ax.group)
                overflow += ov
            _record(out, cur, wid, t)
        return ax.finish(out, overflow)

    return fn


def distributed_uniform_walks(mesh, *, length, vp, n_walkers, slack=4,
                              route_off=False):
    """Uniform-next-hop distributed walks (the hub-safe all-gather engine).

    Returns fn(row_ptr, col_idx, degree, starts, generator) -> (walks
    [n_walkers, length], overflow).
    """
    return _make_first_order(mesh, length=length, vp=vp, n_walkers=n_walkers,
                             slack=slack, weighted=False, route_off=route_off)


def distributed_weighted_walks(mesh, *, length, vp, n_walkers, slack=4):
    """Weighted first-order walks by partitioned per-node alias tables.
    Returns fn(row_ptr, col_idx, degree, accept, alias, starts, generator).
    """
    return _make_first_order(mesh, length=length, vp=vp, n_walkers=n_walkers,
                             slack=slack, weighted=True)


def _local_hops(ax, csr, state, out, length, hops, gen, route_off):
    """`hops` hops of the first-order walkers that are live, not pending and
    not done; a hop that stays on this rank is taken and recorded, one that
    leaves it sets `pend` to the next vertex. state: (cur, wid, t, pend)."""
    cur, wid, t, pend = state
    for _ in range(hops):
        active = (wid >= 0) & (pend < 0) & (t < length)
        lv = ax.lv(cur, active)
        deg = torch.where(active, csr.degree[lv], 0)
        nxt = csr.hop(lv, deg, gen)
        wid = torch.where(active & (deg == 0), -1, wid)  # dead end
        nxt_ok = active & (deg > 0)
        if route_off:  # timing control: crossers clamped onto this rank
            nxt = torch.where(nxt_ok, nxt.clamp(ax.lo, ax.lo + ax.vp - 1),
                              nxt)
        local = nxt_ok & ax.local(nxt)
        cur = torch.where(local, nxt, cur)
        _record(out, torch.where(local, cur, -1),
                torch.where(local, wid, -1), t.clamp(max=length - 1))
        t = torch.where(local, t + 1, t)
        wid = torch.where(t >= length, -1, wid)  # finished
        pend = torch.where(nxt_ok & ~local, nxt, pend)
    return cur, wid, t, pend


def _global_live(wid, ax):
    """The live walkers on all ranks, read on the host."""
    return int(comm.all_reduce((wid >= 0).sum().reshape(1), ax.group))


def _start_rounds(ax, starts, n_walkers, length):
    """(state, out) of a round-based engine: walkers carry their own t."""
    cur, wid = ax.walkers(starts)
    t = torch.where(wid >= 0, 1, length).to(torch.int32)
    out = _new_out(n_walkers, length, cur, wid)
    return (cur, wid, t, torch.full_like(cur, -1)), out


def distributed_uniform_walks_batched(mesh, *, length, vp, n_walkers,
                                      slack=4, hop_batch=4, send_slack=1.0,
                                      route_off=False):
    """Locality-batched uniform walks: route only the walkers that cross.

    Each round lets every walker take up to `hop_batch` local hops, then
    compacts the ones whose next vertex lies on another rank into a
    [send_cap = wl * send_slack] send buffer and all-gathers only that;
    receivers place their arrivals in free slots (`place_arrivals`).
    Crossers beyond send_cap hold their slot and retry next round
    (backpressure, never a drop); arrivals beyond cap hosted walkers are
    the only loss, counted in overflow. The send buffer's last row carries
    this rank's live count, and the host reads the global count once a
    round to decide whether another round runs.

    Returns fn(row_ptr, col_idx, degree, starts, generator) -> (walks,
    overflow, rounds).
    """
    ax = _Axis(mesh, n_walkers, slack, vp)
    send_cap = max(int(ax.wl * send_slack), 1)

    def fn(row_ptr, col_idx, degree, starts, gen):
        csr = _Csr(row_ptr, col_idx, degree)
        state, out = _start_rounds(ax, starts, n_walkers, length)
        ov = torch.zeros((), dtype=torch.int64, device=out.device)
        live = _global_live(state[1], ax)
        rounds = 0
        while live > 0:
            cur, wid, t, pend = _local_hops(ax, csr, state, out, length,
                                            hop_batch, gen, route_off)
            # the live count before the sends leave, so walkers in flight
            # keep the loop alive
            live_here = (wid >= 0).sum()
            is_pend = (wid >= 0) & (pend >= 0)
            rank = is_pend.cumsum(0) - 1
            ok_send = is_pend & (rank < send_cap)
            sbuf = cur.new_full((send_cap + 1, 3), -1)
            _set_rows(sbuf, torch.where(ok_send, rank, send_cap),
                      torch.where(ok_send[:, None],
                                  torch.stack([pend, wid, t], 1), -1))
            sbuf[send_cap, 0] = live_here  # the trash row, all -1 now
            wid = torch.where(ok_send, -1, wid)
            pend = torch.where(ok_send, -1, pend)
            allw = comm.all_gather(sbuf, ax.group)  # [n, send_cap+1, 3]
            live = int(allw[:, send_cap, 0].sum())
            arrivals = allw[:, :send_cap].reshape(-1, 3)
            arrivals = torch.where(ax.local(arrivals[:, :1]), arrivals, -1)
            *state, _, ov_r = place_arrivals(cur, wid, t, pend, out,
                                             arrivals, length)
            ov += ov_r
            rounds += 1
        return (*ax.finish(out, ov), rounds)

    return fn


def _bucket_caps(ax, bucket_cap):
    """(bcap, send_cap) of the a2a engines: bcap = max(ceil(4 wl / n), 64)
    rows a destination by default, at most send_cap = 2 wl crossers a
    round."""
    return bucket_cap or max(-(-4 * ax.wl // ax.n), 64), 2 * ax.wl


def _send_crossers(ax, wid, pend, third, bcap, send_cap, exchange):
    """One round's exchange of the crossers (pending walkers; rows: next
    vertex, walk id, `third`). The live count is taken before the sends
    leave, so walkers in flight keep the loop alive; the sent walkers leave
    this rank, the held ones retry. Returns (wid, pend, arrivals, global
    live count, rows sent)."""
    live_here = (wid >= 0).sum()
    sbuf, sent = bucket_by_dest(
        torch.where((wid >= 0) & (pend >= 0), pend, -1), wid, third, ax.vp,
        ax.n, bcap, send_cap=send_cap)
    arrivals, live = exchange(sbuf.view(ax.n, bcap, 3), live_here, ax.group)
    return (torch.where(sent, -1, wid), torch.where(sent, -1, pend),
            arrivals, live, sent.sum())


def distributed_uniform_walks_a2a(mesh, *, length, vp, n_walkers, slack=4,
                                  hop_batch=1, bucket_cap=None,
                                  route_off=False, weighted=False,
                                  exchange=ragged_exchange):
    """Crossers-only exchange walks, uniform or weighted.

    Each round: up to `hop_batch` local hops; the crossers bucketed by
    destination (`bucket_by_dest`, `_bucket_caps`: the rest held for the
    next round); one exchange (`ragged_exchange`: each
    bucket's occupied rows, the live count riding on the count exchange);
    arrivals placed in free slots (`place_arrivals`). Bucket overflow is
    backpressure; arrivals beyond cap hosted walkers are counted in
    overflow. `route_off=True` (timing control without meaning) clamps
    crossers onto their rank and runs no exchange: ceil((length - 1) /
    hop_batch) rounds, a count known in advance.

    `exchange` is `ragged_exchange`, or `dense_exchange` (the JAX
    package's frame) for the tests that hold one against the other.

    Returns fn(row_ptr, col_idx, degree, [accept, alias when weighted,]
    starts, generator) -> (walks, overflow, rounds, crossed): crossed is
    the number of walker rows exchanged over the run, on all ranks.
    """
    ax = _Axis(mesh, n_walkers, slack, vp)
    bcap, send_cap = _bucket_caps(ax, bucket_cap)
    rounds_ctl = -(-(length - 1) // hop_batch)

    def fn(row_ptr, col_idx, degree, *rest):
        *alias_t, starts, gen = rest
        csr = _Csr(row_ptr, col_idx, degree, *alias_t)
        state, out = _start_rounds(ax, starts, n_walkers, length)
        zero = torch.zeros((), dtype=torch.int64, device=out.device)
        ov, xs = zero, zero
        live = 1 if route_off else _global_live(state[1], ax)
        rounds = 0
        while (rounds < rounds_ctl) if route_off else live > 0:
            cur, wid, t, pend = state = _local_hops(
                ax, csr, state, out, length, hop_batch, gen, route_off)
            if not route_off:
                wid, pend, arrivals, live, sent = _send_crossers(
                    ax, wid, pend, t, bcap, send_cap, exchange)
                *state, _, ov_r = place_arrivals(cur, wid, t, pend, out,
                                                 arrivals, length)
                ov, xs = ov + ov_r, xs + sent
            rounds += 1
        out, ov, xs = ax.finish(out, ov, xs)
        return out, ov, rounds, xs

    return fn


def distributed_node2vec_walks(mesh, *, length, vp, dpad, n_walkers, p, q,
                               slack=4):
    """Exact (p,q) second-order distributed walks.

    The bias of each candidate x in N(cur) against prev needs N(prev),
    whose owner may be another rank: prev's padded neighbor row is
    halo-fetched each step (`_fetch_rows_i32`), membership is the exact
    test of `ops.walk.node2vec_walks` (a search of each candidate in prev's
    sorted row, the port's form of the JAX package's blocked compare), and
    a Gumbel-max draw picks the next hop. The first hop is an unbiased
    weighted draw (so it fetches nothing).

    Returns fn(nbr [Vp, Dpad], nbr_w [Vp, Dpad], degree [Vp], starts,
    generator) -> (walks, overflow).
    """
    del dpad  # the rows' width is the tensors'
    ax = _Axis(mesh, n_walkers, slack, vp)
    inv_p, inv_q = 1.0 / float(p), 1.0 / float(q)

    def fn(nbr, nbr_w, degree, starts, gen):
        cur, wid = ax.walkers(starts)
        prev = torch.full_like(cur, -1)
        out = _new_out(n_walkers, length, cur, wid)
        overflow = torch.zeros((), dtype=torch.int64, device=cur.device)
        for t in range(1, length):
            alive = wid >= 0
            lv = ax.lv(cur, alive)
            cand = nbr[lv]  # [cap, Dpad]
            w = nbr_w[lv]
            if t > 1:
                prev_row = _fetch_rows_i32(nbr, prev, ax.lo, vp, ax.group)
                in_prev = rows_contain(sorted_rows(prev_row), cand)
                w = w * torch.where(cand == prev[:, None], inv_p,
                                    torch.where(in_prev, 1.0, inv_q))
            nxt = cand.gather(1, _gumbel_pick(w, gen))[:, 0]
            deg = torch.where(alive, degree[lv], 0)
            nxt = torch.where(alive & (deg > 0), nxt, -1)
            wid = torch.where(nxt >= 0, wid, -1)
            (cur, wid, prev), ov = _route([nxt, wid, cur], ax.lo, vp,
                                          ax.cap, ax.group)
            overflow += ov
            _record(out, cur, wid, t)
        return ax.finish(out, overflow)

    return fn


def distributed_node2vec_rejection_walks(mesh, *, length, vp, n_walkers, p,
                                         q, max_degree, slack=4,
                                         proposals=32, envelope=False):
    """(p,q) walks by rejection over the partitioned CSR, no dense rows.

    Each walker draws `proposals` (T) candidates from its local alias row
    up front (they are i.i.d., so a batch equals a retry loop); one query
    exchange a step answers all memberships "candidate in N(prev)" on
    prev's owner: the (prev, candidates) queries are all-gathered, the
    owner answers by binary search in its CSR (`csr_contains`), and an
    all-to-all with a select by owner returns the answers. The first
    accepted candidate wins; with none accepted the last one is taken (the
    single-device sampler's documented bias). The first hop is an unbiased
    weighted draw.

    `envelope=True` (unit weights only; the caller gates): the prev-point
    mixture, acceptance floor min(q, 1/q, 1). Its mass uses the degree, not
    a cumsum of weights, so the f32 wsum fault of the JAX package's
    `ops/walk.py:641-644` cannot reach this engine.

    Returns fn(row_ptr, col_idx, degree, accept, alias, starts, generator)
    -> (walks, overflow).
    """
    ax = _Axis(mesh, n_walkers, slack, vp)
    T = proposals
    inv_p, inv_q = 1.0 / float(p), 1.0 / float(q)
    ub = max(inv_p, 1.0, inv_q)
    beta = max(1.0, inv_q)
    a_coef = max(inv_p - beta, 0.0)
    cap = ax.cap

    def fn(row_ptr, col_idx, degree, acc_t, ali_t, starts, gen):
        row_ptr = row_ptr.long()
        last = col_idx.shape[0] - 1
        dev = starts.device

        def rand(shape):
            return torch.rand(shape, generator=gen, device=dev)

        def contains(rows, values):
            return csr_contains(row_ptr, col_idx, degree, rows, values,
                                max_degree=max_degree)

        cur, wid = ax.walkers(starts)
        prev = torch.full_like(cur, -1)
        out = _new_out(n_walkers, length, cur, wid)
        overflow = torch.zeros((), dtype=torch.int64, device=dev)
        rows = torch.arange(cap, device=dev)
        for t in range(1, length):
            alive = wid >= 0
            lv = ax.lv(cur, alive)
            deg = torch.where(alive, degree[lv], 0)
            offs = row_ptr[lv][:, None].expand(cap, T)
            degb = deg.clamp(min=1).long()[:, None].expand(cap, T)
            slot = alias_draw(acc_t, ali_t, offs, degb, rand((cap, T)),
                              rand((cap, T)))
            cand = col_idx[(offs + slot).clamp(max=last)]
            if t == 1:
                pick = torch.zeros(cap, dtype=torch.long, device=dev)
            else:
                psafe = prev.clamp(min=0)
                if envelope:
                    # prev-point mixture: w_prev = [prev in N(cur)] (cur is
                    # local: one local test), wsum = the degree
                    found = contains(lv, psafe) & (prev >= 0) & alive
                    a_mass = a_coef * found.to(torch.float32)
                    p_point = a_mass / (a_mass + beta * deg.to(
                        torch.float32)).clamp(min=1e-30)
                    cand = torch.where(rand((cap, T)) < p_point[:, None],
                                       psafe[:, None].to(cand.dtype), cand)
                # one membership exchange for all T proposals, answered on
                # prev's owner
                qall = comm.all_gather(torch.cat([prev[:, None], cand], 1),
                                       ax.group)  # [n, cap, 1+T]
                qp = qall[:, :, 0].reshape(-1)
                owned = ax.local(qp)
                qlv = torch.where(owned, qp - ax.lo, 0).long()
                found = contains(qlv[:, None].expand(-1, T),
                                 qall[:, :, 1:].reshape(-1, T))
                found = (found & owned[:, None]).to(torch.uint8)
                ans = comm.all_to_all(found.view(ax.n, cap, T), ax.group)
                ans = ans[psafe.long() // vp, rows] > 0  # [cap, T]
                is_prev = cand == prev[:, None]
                factor = torch.where(is_prev, inv_p,
                                     torch.where(ans, 1.0, inv_q))
                env = beta + torch.where(is_prev, a_coef, 0.0) if envelope \
                    else ub
                accepted = rand((cap, T)) < factor / env
                first = accepted.to(torch.uint8).argmax(1)
                pick = torch.where(accepted.any(1), first, T - 1)
            nxt = cand.gather(1, pick[:, None])[:, 0]
            nxt = torch.where(alive & (deg > 0), nxt, -1)
            wid = torch.where(nxt >= 0, wid, -1)
            (cur, wid, prev), ov = _route([nxt, wid, cur], ax.lo, vp, cap,
                                          ax.group)
            overflow += ov
            _record(out, cur, wid, t)
        return ax.finish(out, overflow)

    return fn


def _multilayer_local_steps(row_ptr, col_idx, accept, alias_t, gamma):
    """Per-rank step closures of the two multilayer engines.

    row_ptr [K, Vp+1], col_idx/accept/alias [K, E] and gamma [K, Vp] are
    one rank's stacked layer structures. Returns (move, neighbor_step):
    `move(layer, lv, r2, moving)` is one layer move (up with probability
    x / (x + 1), x = log(gamma + e), where the layer above exists and has
    edges at the vertex, else down where the layer is above 0), and
    `neighbor_step(layer, lv, v_global, u1, u2)` the in-layer alias hop,
    which stays at v_global on a row without edges. Shared so that a fix
    reaches both engines.
    """
    K, Vp1 = row_ptr.shape
    vp, e_cols = Vp1 - 1, col_idx.shape[1]
    dev = row_ptr.device
    rp = row_ptr.long()
    layers = torch.arange(K, device=dev)
    deg = rp[:, 1:] - rp[:, :-1]  # [K, Vp]
    first = rp[:, :-1] + e_cols * layers[:, None]
    x = torch.log(gamma + math.e)
    p_up = x / (x + 1.0)
    up_deg = deg[(layers + 1).clamp(max=K - 1)]
    can_up = (layers[:, None] + 1 < K) & (up_deg > 0)
    deg, first, p_up, can_up = (a.reshape(-1) for a in (deg, first, p_up,
                                                        can_up))
    cols, acc, ali = (a.reshape(-1) for a in (col_idx, accept, alias_t))

    def move(layer, lv, r2, moving):
        idx = layer * vp + lv
        up = moving & (r2 <= p_up[idx]) & can_up[idx]
        down = moving & (r2 > p_up[idx]) & (layer > 0)
        return layer + up.long() - down.long()

    def neighbor_step(layer, lv, v_global, u1, u2):
        idx = layer * vp + lv
        d, flat = deg[idx], first[idx]
        slot = alias_draw(acc, ali, flat, d.clamp(min=1), u1, u2)
        nxt = cols[(flat + slot).clamp(max=K * e_cols - 1)]
        return torch.where(d > 0, nxt, v_global)

    return move, neighbor_step


def _emission(steps, layer, lv, cur, active, sp, max_moves, gen):
    """One emission's tries (the single-device `multilayer_walks`' law):
    up to max_moves tries of a neighbor step (probability sp) or else a
    layer move, then a forced step in the final layer for walkers that made
    none. Returns (next vertex, layer); walkers not active keep their layer
    (their vertex is the caller's to mask)."""
    move, neighbor_step = steps
    u = torch.rand((4 * max_moves + 2, cur.shape[0]), generator=gen,
                   device=cur.device)
    stepped = torch.zeros_like(active)
    nxt = cur
    for i in range(max_moves):
        r, u1, u2, r2 = u[4 * i: 4 * i + 4]
        do_step = (r < sp) & ~stepped
        nxt = torch.where(do_step, neighbor_step(layer, lv, cur, u1, u2), nxt)
        stepped = stepped | do_step
        layer = move(layer, lv, r2, ~stepped & active)
    forced = neighbor_step(layer, lv, cur, u[-2], u[-1])
    return torch.where(stepped, nxt, forced), layer


def distributed_multilayer_walks(mesh, *, length, vp, n_walkers, stay_prob,
                                 max_moves=16, slack=4):
    """Struc2Vec biased multilayer walks over partitioned layer CSRs.

    The single-device `models.struc2vec.multilayer_walks` law: a bounded
    loop of tries a step, a forced step when it runs out. A layer move
    keeps the vertex, so it stays on its rank; only the in-layer hop routes
    the walker (its layer rides along).

    Returns fn(row_ptr [K, Vp+1], col_idx [K, E], accept [K, E], alias [K,
    E], gamma [K, Vp], starts, generator) -> (walks, overflow).
    """
    ax = _Axis(mesh, n_walkers, slack, vp)

    def fn(row_ptr, col_idx, accept, alias, gamma, starts, gen):
        steps = _multilayer_local_steps(row_ptr, col_idx, accept, alias,
                                        gamma)
        cur, wid = ax.walkers(starts)
        layer = torch.zeros_like(cur)
        out = _new_out(n_walkers, length, cur, wid)
        overflow = torch.zeros((), dtype=torch.int64, device=cur.device)
        for t in range(1, length):
            alive = wid >= 0
            lv = ax.lv(cur, alive)
            nxt, layer = _emission(steps, layer.long(), lv, cur, alive,
                                   stay_prob, max_moves, gen)
            nxt = torch.where(alive, nxt, -1)
            wid = torch.where(nxt >= 0, wid, -1)
            (cur, wid, layer), ov = _route(
                [nxt, wid, layer.to(cur.dtype)], ax.lo, vp, ax.cap, ax.group)
            layer = layer.clamp(min=0)  # -1 fill of empty slots
            overflow += ov
            _record(out, cur, wid, t)
        return ax.finish(out, overflow)

    return fn


def distributed_multilayer_walks_a2a(mesh, *, length, vp, n_walkers,
                                     stay_prob, max_moves=16, slack=4,
                                     bucket_cap=None,
                                     exchange=ragged_exchange):
    """Struc2Vec multilayer walks through the crossers-only exchange.

    The walk law of `distributed_multilayer_walks`; the rounds of
    `distributed_uniform_walks_a2a`, one emission a round. (layer, t) rides
    the exchange packed into the third column as layer * 2**16 + t, so
    `bucket_by_dest`'s 3-column frame serves unchanged; hence walk lengths
    of 2**16 and more are refused.

    Returns fn(row_ptr, col_idx, accept, alias, gamma, starts, generator)
    -> (walks, overflow, rounds, crossed).
    """
    if length >= _PACK:
        raise ValueError(
            f"walk_length {length} >= 2^16 would corrupt the packed "
            "(layer, t) exchange column; use the all-gather multilayer "
            "engine for such walks")
    ax = _Axis(mesh, n_walkers, slack, vp)
    bcap, send_cap = _bucket_caps(ax, bucket_cap)

    def fn(row_ptr, col_idx, accept, alias, gamma, starts, gen):
        steps = _multilayer_local_steps(row_ptr, col_idx, accept, alias,
                                        gamma)
        (cur, wid, t, pend), out = _start_rounds(ax, starts, n_walkers,
                                                 length)
        layer = torch.zeros_like(cur)
        zero = torch.zeros((), dtype=torch.int64, device=cur.device)
        ov, xs = zero, zero
        live = _global_live(wid, ax)
        rounds = 0
        while live > 0:
            active = (wid >= 0) & (pend < 0) & (t < length)
            lv = ax.lv(cur, active)
            nxt, layer = _emission(steps, layer.long(), lv, cur, active,
                                   stay_prob, max_moves, gen)
            layer = layer.to(cur.dtype)
            local = active & ax.local(nxt)
            cur = torch.where(local, nxt, cur)
            _record(out, torch.where(local, cur, -1),
                    torch.where(local, wid, -1), t.clamp(max=length - 1))
            t = torch.where(local, t + 1, t)
            wid = torch.where(t >= length, -1, wid)
            pend = torch.where(active & ~local, nxt, pend)
            wid, pend, arr, live, sent = _send_crossers(
                ax, wid, pend, layer * _PACK + t, bcap, send_cap, exchange)
            x_a = arr[:, 2].clamp(min=0)
            cur, wid, t, pend, out, ov_r, layer = place_arrivals(
                cur, wid, t, pend, out,
                torch.stack([arr[:, 0], arr[:, 1], x_a % _PACK], 1), length,
                extra=layer, extra_arrivals=x_a // _PACK)
            ov, xs = ov + ov_r, xs + sent
            rounds += 1
        out, ov, xs = ax.finish(out, ov, xs)
        return out, ov, rounds, xs

    return fn


# --------------------------------------------------------------------------- #
# high-level wrappers
# --------------------------------------------------------------------------- #


class DistributedWalker:
    """Reusable distributed walk engine: partition once, walk many times.

    Every rank of the mesh constructs it with the same arguments (the
    graph, or Struc2Vec's `layers`, on every rank) and keeps only its own
    shard, on the mesh's device; then `run(seed)` on every rank walks the
    corpus, which every rank receives whole. kind: 'uniform', 'weighted',
    'node2vec' (exact), 'node2vec_rejection' or 'multilayer' (`layers`,
    `num_nodes`); `exchange='a2a'` takes the crossers-only engines
    (uniform, weighted, multilayer), `hop_batch > 0` the batched uniform
    engine; `relabel` ('locality' or a permutation, uniform only) walks a
    relabeled graph and maps the corpus back.
    """

    last_rounds = None  # routing rounds of the last batched or a2a run
    last_crossed = None  # exchanged rows of the last a2a run

    def __init__(self, graph, mesh, walk_length, *, kind="uniform",
                 num_walks=1, p=1.0, q=1.0, slack=4, stay_prob=0.3,
                 max_moves=16, layers=None, num_nodes=None,
                 route_off=False, hop_batch=0, send_slack=2.0,
                 relabel=None, proposals=32, exchange=None,
                 bucket_cap=None):
        self.mesh = check_mesh(mesh)
        self.kind = kind
        n = mesh.size("data")
        me = mesh.get_local_rank("data")
        self._perm = None
        if relabel is not None:
            if kind != "uniform":
                raise ValueError(
                    "relabel= is currently wired for kind='uniform'")
            if relabel == "locality":
                perm = locality_order(graph)
            else:
                perm = np.asarray(relabel, dtype=np.int64)
            graph = relabel_graph(graph, perm)
            self._perm = perm  # perm[new_id] = old_id
        V = graph.num_nodes if graph is not None else num_nodes
        vp = (V + n - 1) // n
        self.num_nodes = V
        starts, n_walkers = _group_starts(V, num_walks, n, vp)

        if route_off and kind != "uniform":
            raise ValueError("route_off is a uniform-kind timing control "
                             "(scaling harness only)")
        if exchange not in (None, "a2a"):
            raise ValueError(f"unknown exchange {exchange!r} (None = "
                             "all-gather engines, 'a2a' = crossers-only "
                             "exchange)")
        if exchange == "a2a" and kind not in ("uniform", "weighted",
                                              "multilayer"):
            raise ValueError("exchange='a2a' is wired for the first-order "
                             "kinds ('uniform'/'weighted') and "
                             "'multilayer'")
        common = dict(length=walk_length, vp=vp, n_walkers=n_walkers,
                      slack=slack)

        def alias_parts():
            accept, alias = graph.host_alias()
            return partition_csr(graph, n, edge_arrays={
                "accept": (accept.astype(np.float32), 1.0),
                "alias": (alias.astype(np.int32), 0)})

        csr_keys = ("row_ptr", "col_idx", "degree")
        alias_keys = csr_keys + ("accept", "alias")
        layer_keys = ("row_ptr", "col_idx", "accept", "alias", "gamma")
        if kind == "multilayer":
            parts, keys = partition_layers(layers, V, n), layer_keys
            if exchange == "a2a":
                self._fn = distributed_multilayer_walks_a2a(
                    mesh, stay_prob=stay_prob, max_moves=max_moves,
                    bucket_cap=bucket_cap, **common)
            else:
                self._fn = distributed_multilayer_walks(
                    mesh, stay_prob=stay_prob, max_moves=max_moves, **common)
        elif exchange == "a2a":
            weighted = kind == "weighted"
            parts = alias_parts() if weighted else partition_csr(graph, n)
            keys = alias_keys if weighted else csr_keys
            self._fn = distributed_uniform_walks_a2a(
                mesh, hop_batch=max(hop_batch, 1), bucket_cap=bucket_cap,
                route_off=route_off, weighted=weighted, **common)
        elif kind == "uniform" and hop_batch:
            parts, keys = partition_csr(graph, n), csr_keys
            self._fn = distributed_uniform_walks_batched(
                mesh, hop_batch=hop_batch, send_slack=send_slack,
                route_off=route_off, **common)
        elif kind == "uniform":
            parts, keys = partition_csr(graph, n), csr_keys
            self._fn = distributed_uniform_walks(mesh, route_off=route_off,
                                                 **common)
        elif kind == "weighted":
            parts, keys = alias_parts(), alias_keys
            self._fn = distributed_weighted_walks(mesh, **common)
        elif kind == "node2vec":
            nbr, nbr_w, deg, _, dpad = partition_neighbor_matrix(graph, n)
            parts = {"nbr": nbr, "nbr_w": nbr_w, "degree": deg}
            keys = ("nbr", "nbr_w", "degree")
            self._fn = distributed_node2vec_walks(mesh, dpad=dpad, p=p, q=q,
                                                  **common)
        elif kind == "node2vec_rejection":
            parts, keys = alias_parts(), alias_keys
            self._fn = distributed_node2vec_rejection_walks(
                mesh, p=p, q=q, proposals=proposals,
                max_degree=int(graph.degree.max(initial=0)),
                # the envelope's mass needs the edge weights: unit ones
                envelope=graph.unit_weights, **common)
        else:
            raise ValueError(f"unknown distributed walk kind: {kind!r}")
        # this rank's shard only, on the mesh's device
        self._args = tuple(torch.as_tensor(parts[k][me]).to(mesh.device)
                           for k in keys)
        self._starts = torch.as_tensor(starts[me]).to(mesh.device)

    def run_device(self, seed):
        """One engine call from `seed` on every rank; returns (walks
        [n_walkers, length] int32 on the mesh's device, filler rows (first
        token -1) still in, overflow as a 0-d tensor)."""
        gen = torch.Generator(device=self.mesh.device)
        gen.manual_seed(rank_seed(seed, self.mesh.get_local_rank("data")))
        out = self._fn(*self._args, self._starts, gen)
        if len(out) == 4:  # a2a: rounds and exchanged rows
            walks, ov, self.last_rounds, crossed = out
            self.last_crossed = int(crossed)
            return walks, ov
        if len(out) == 3:  # batched: rounds
            walks, ov, self.last_rounds = out
            return walks, ov
        return out

    def run_tensor(self, seed):
        """(walks [kept, length] int32 on the mesh's device, overflow):
        filler rows dropped, tokens in the caller's vertex ids."""
        walks, overflow = self.run_device(seed)
        walks = walks[walks[:, 0] >= 0]
        if self._perm is not None:
            perm = torch.as_tensor(self._perm, device=walks.device)
            walks = torch.where(walks >= 0, perm[walks.long().clamp(
                min=0)].to(torch.int32), -1)
        return walks, int(overflow)

    def run(self, seed):
        """The corpus as numpy, filler rows dropped and relabeling undone:
        (walks [kept, length] int32, overflow count)."""
        walks, overflow = self.run_tensor(seed)
        return walks.cpu().numpy(), overflow


def simulate_walks_distributed(graph, mesh, num_walks, walk_length, seed, *,
                               kind="uniform", p=1.0, q=1.0, slack=4):
    """One-shot distributed walk corpus (walks grouped by owner rank).

    kind: 'uniform', 'weighted' or 'node2vec'. Returns (walks [kept,
    length] numpy, overflow). For repeated corpora over one graph and mesh,
    build a `DistributedWalker` once and call `run(seed)`.
    """
    return DistributedWalker(graph, mesh, walk_length, kind=kind,
                             num_walks=num_walks, p=p, q=q,
                             slack=slack).run(seed)


def simulate_multilayer_walks_distributed(layers, num_nodes, mesh, num_walks,
                                          walk_length, seed, *,
                                          stay_prob=0.3, max_moves=16,
                                          slack=4):
    """One-shot distributed struc2vec multilayer walk corpus (`layers` is
    the `build_layer_csr` dict). Returns (walks, overflow)."""
    return DistributedWalker(None, mesh, walk_length, kind="multilayer",
                             num_walks=num_walks, stay_prob=stay_prob,
                             max_moves=max_moves, slack=slack, layers=layers,
                             num_nodes=num_nodes).run(seed)
