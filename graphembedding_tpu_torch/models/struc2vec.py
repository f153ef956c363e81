"""Struc2Vec (Ribeiro et al., KDD'17): structural-role embeddings.

Counterpart of `graphembedding_tpu/models/struc2vec.py`. The context graph
is built once on the host: per-node BFS ring degree sequences (opt1:
run-length compressed), DTW distances between ~2 log2 V degree-similar node
pairs (opt2), cumulative over the layers, become K layers of undirected
edges weighted exp(-f_k) (`build_context_graph`), stacked into padded CSRs
with per-row alias tables and each vertex's count of heavier-than-average
edges, gamma (`build_layer_csr`). The result is pickled to `temp_path`,
keyed by a hash of the graph and the options. The biased multilayer walk
runs on the model's device, on a card as one launch of the walk kernel K9
(`multilayer_walks`, `csrc/walk.cu`), on the CPU in plain PyTorch
(`multilayer_walks_plain`), and
`train` fits hierarchical softmax (hs='auto' up to `HS_AUTO_MAX_NODES`
nodes) or SGNS over the walks.

With opt1 (the default) the distances come from the C++ library in
`graphembedding_tpu_torch/native/`, built at first use; a missing compiler
or a failed build raises. The Python pipeline (`_bfs_degree_lists`,
`_dtw`, `_fastdtw`) computes them for `opt1_reduce_len=False`, which the
C++ path does not cover, and is the tests' oracle.

`Struc2Vec(G, mesh=m)` walks over a mesh (`parallel.walks`, the layer CSRs
split over its data axis; every rank gets the whole corpus), and `train`
then trains over the same mesh (`parallel/`) unless given another.
"""

from __future__ import annotations

import hashlib
import math
import os
import pickle

import numpy as np
import torch

from graphembedding_tpu_torch import native
from graphembedding_tpu_torch.kernels import build as kb
from graphembedding_tpu_torch.models.base import WalkEmbeddingModel
from graphembedding_tpu_torch.ops.alias import alias_draw, build_row_alias
from graphembedding_tpu_torch.ops.walk import (
    Uniforms,
    check_tensor,
    kernel_rng,
    on_card,
    ptr_or_null,
    walk_starts,
)

# pairs a chunk of the distance build holds: its f64 [chunk, layers]
# buffer is freed before the next chunk
PAIR_CHUNK = 2_000_000


# --------------------------------------------------------------------------- #
# host pipeline
# --------------------------------------------------------------------------- #


def _bfs_degree_lists(row_ptr, col_idx, degree, num_nodes, max_layers,
                      opt1=True):
    """Per node: a list over layers of the degree sequence of its BFS ring.

    opt1 compresses each ring to sorted (degree, count) pairs, else a
    sorted degree array. The CSR is the symmetrized adjacency.
    """
    out = []
    for root in range(num_nodes):
        seen = np.zeros(num_nodes, dtype=bool)
        seen[root] = True
        frontier = np.array([root], dtype=np.int64)
        layers = []
        for _ in range(max_layers):
            if frontier.size == 0:
                break
            degs = np.sort(degree[frontier])
            if opt1:
                vals, counts = np.unique(degs, return_counts=True)
                layers.append(np.stack([vals.astype(np.float64),
                                        counts.astype(np.float64)], axis=1))
            else:
                layers.append(degs.astype(np.float64))
            nxt = [col_idx[row_ptr[v]: row_ptr[v + 1]] for v in frontier]
            nxt = np.unique(np.concatenate(nxt))
            nxt = nxt[~seen[nxt]]
            seen[nxt] = True
            frontier = nxt
        out.append(layers)
    return out


def _dtw(seq_a, seq_b, opt1=True):
    """Exact O(nm) DTW with the struc2vec ground cost.

    opt1 sequences are (degree, count) pairs with cost (max/min - 1) *
    max(count_a, count_b) (the reference's `cost_max`); plain sequences use
    max/min - 1 (its `cost`).
    """
    if opt1:
        a_deg, a_cnt = seq_a[:, 0], seq_a[:, 1]
        b_deg, b_cnt = seq_b[:, 0], seq_b[:, 1]
        mx = np.maximum.outer(a_deg, b_deg)
        mn = np.minimum.outer(a_deg, b_deg)
        cost = (mx / np.maximum(mn, 1e-12) - 1.0) * np.maximum.outer(
            a_cnt, b_cnt)
    else:
        mx = np.maximum.outer(seq_a, seq_b)
        mn = np.minimum.outer(seq_a, seq_b)
        cost = mx / np.maximum(mn, 1e-12) - 1.0
    n, m = cost.shape
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        D[i, 1:] = cost[i - 1]
        for j in range(1, m + 1):
            D[i, j] += min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return float(D[n, m])


def _fastdtw(seq_a, seq_b, radius=1):
    """fastdtw (Salvador & Chan) on (degree, count) RLE pairs.

    The Python mirror of the C++ `fastdtw_rle`: componentwise
    half-reduction (odd tail dropped, as in the pip package the reference
    calls), coarse solve, radius-expanded window, windowed fine DTW. It
    overestimates the exact DTW by construction (banded).
    """
    def cost(pa, pb):
        mx = max(pa[0], pb[0])
        mn = max(min(pa[0], pb[0]), 1e-12)
        return (mx / mn - 1.0) * max(pa[1], pb[1])

    def windowed(a, b, band, want_path):
        n, m = len(a), len(b)
        INF = float("inf")
        vals = [{0: 0.0}]
        for i in range(1, n + 1):
            lo, hi = band[i - 1]
            row = {}
            for j in range(max(lo, 1), hi + 1):
                best = min(vals[i - 1].get(j, INF), row.get(j - 1, INF),
                           vals[i - 1].get(j - 1, INF))
                if best < INF:
                    row[j] = cost(a[i - 1], b[j - 1]) + best
            vals.append(row)
        if not want_path:
            return vals[n].get(m, INF), None
        path, i, j = [], n, m
        while i >= 1 and j >= 1:
            path.append((i, j))
            if i == 1 and j == 1:
                break
            opts = [(vals[i - 1].get(j - 1, INF), i - 1, j - 1),
                    (vals[i - 1].get(j, INF), i - 1, j),
                    (vals[i].get(j - 1, INF), i, j - 1)]
            _, i, j = min(opts, key=lambda t: t[0])
        return vals[n].get(m, INF), path[::-1]

    def rec(a, b, want_path):
        n, m = len(a), len(b)
        if n == 0 or m == 0:
            return 0.0, []
        if n <= radius + 2 or m <= radius + 2:
            return windowed(a, b, [(1, m)] * n, want_path)
        ha = [((a[2 * i][0] + a[2 * i + 1][0]) / 2.0,
               (a[2 * i][1] + a[2 * i + 1][1]) / 2.0)
              for i in range(n // 2)]
        hb = [((b[2 * j][0] + b[2 * j + 1][0]) / 2.0,
               (b[2 * j][1] + b[2 * j + 1][1]) / 2.0)
              for j in range(m // 2)]
        _, cpath = rec(ha, hb, True)
        cn, cm = len(ha), len(hb)
        coarse = [(cm + 1, 0)] * cn
        for ci, cj in cpath:
            for i in range(max(ci - radius, 1), min(ci + radius, cn) + 1):
                lo, hi = coarse[i - 1]
                coarse[i - 1] = (min(lo, max(cj - radius, 1)),
                                 max(hi, min(cj + radius, cm)))
        band = []
        for i in range(1, n + 1):
            ci = min((i + 1) // 2, cn)
            lo, hi = coarse[ci - 1]
            band.append((max(2 * lo - 1, 1), min(2 * hi, m)))
        band[0] = (1, band[0][1])
        band[-1] = (band[-1][0], m)
        for i in range(1, n):
            lo, hi = band[i]
            plo, phi = band[i - 1]
            band[i] = (min(lo, phi + 1), max(hi, phi))
        return windowed(a, b, band, want_path)

    a = [tuple(p) for p in np.asarray(seq_a).reshape(-1, 2)]
    b = [tuple(p) for p in np.asarray(seq_b).reshape(-1, 2)]
    d, _ = rec(a, b, False)
    return float(d)


def _depth_bound(row_ptr, col_idx, V):
    """Upper bound on the BFS ring depth: the most over components of 2 *
    ecc(seed) + 1 (at least that component's diameter + 1), in O(V + E)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    col_idx = np.asarray(col_idx, dtype=np.int64)
    seen = np.zeros(V, dtype=bool)
    bound = 1
    for s in range(V):
        if seen[s]:
            continue
        seen[s] = True
        frontier = np.array([s], dtype=np.int64)
        depth = 0
        while frontier.size:
            starts = row_ptr[frontier]
            ln = row_ptr[frontier + 1] - starts
            total = int(ln.sum())
            if total == 0:
                break
            # flat indices of every frontier vertex's neighbor slice
            pos = (np.arange(total, dtype=np.int64)
                   - np.repeat(np.cumsum(ln) - ln, ln)
                   + np.repeat(starts, ln))
            nbrs = col_idx[pos]
            nbrs = nbrs[~seen[nbrs]]
            if nbrs.size == 0:
                break
            frontier = np.unique(nbrs)
            seen[frontier] = True
            depth += 1
        bound = max(bound, 2 * depth + 1)
    return bound


def _similar_degree_pairs(degree, num_nodes):
    """opt2: the unique (u < v) pairs where each node is compared to the
    ~2 log2 V nodes of closest degree (the reference's `get_vertices`)."""
    V = num_nodes
    order = np.argsort(degree, kind="stable")
    k = max(int(2 * math.log2(max(V, 2))), 2)
    pos_of = np.empty(V, dtype=np.int64)
    pos_of[order] = np.arange(V)
    offs = np.arange(-k, k + 1, dtype=np.int64)
    cand_pos = pos_of[:, None] + offs[None, :]  # [V, 2k+1]
    valid = (cand_pos >= 0) & (cand_pos < V)
    cand = order[np.clip(cand_pos, 0, V - 1)]
    me = np.arange(V, dtype=np.int64)[:, None]
    valid &= cand != me
    u = np.broadcast_to(me, cand.shape)[valid]
    v = cand[valid]
    key = np.unique(np.minimum(u, v) * V + np.maximum(u, v))
    return key // V, key % V


def _python_distances(degree_lists, pu, pv, ml, opt1, dtw_mode,
                      dtw_early_stop):
    """The Python pipeline's (dist [n, ml], n_layers [n]) for node pairs,
    the C++ `struc2vec_distances`' contract."""
    m = pu.shape[0]
    dist = np.zeros((m, ml), dtype=np.float64)
    nlay = np.zeros(m, dtype=np.int64)
    for i in range(m):
        lu, lv = degree_lists[pu[i]], degree_lists[pv[i]]
        acc = 0.0
        used = 0
        for k in range(min(len(lu), len(lv), ml)):
            if dtw_early_stop and acc >= dtw_early_stop:
                break
            if dtw_mode == "fastdtw" and opt1:
                acc += _fastdtw(lu[k], lv[k])
            else:
                acc += _dtw(lu[k], lv[k], opt1=opt1)
            dist[i, k] = acc
            used = k + 1
        nlay[i] = used
    return dist, nlay


def build_context_graph(graph, max_layers=None, opt1=True, opt2=True,
                        workers=1, dtw_mode="fastdtw", dtw_early_stop=35.0):
    """Structural distances -> per-layer edge lists with weights exp(-f_k).

    Returns (layer_edges, num_layers) where layer_edges[k] is an array
    triple (u, v, w) of the layer's undirected edges with u < v. With opt1
    the C++ library computes the distances, its BFS and per-pair DTW loops
    on `workers` threads (None/0: all hardware threads); without it the
    Python pipeline does. `dtw_mode`: 'fastdtw' (radius 1, what the
    reference computes, O(n) a pair) or 'exact' (the O(nm) DP). The pairs
    go in chunks of PAIR_CHUNK.
    """
    workers = workers if workers else 0  # 0 -> all threads (native)
    # the symmetrized adjacency, deduplicated by a packed (u * V + v) key,
    # which also leaves each row's neighbors sorted
    src, dst, _ = graph.edges()
    V = graph.num_nodes
    mask = src != dst
    u_all = np.concatenate([src[mask], dst[mask]]).astype(np.int64)
    v_all = np.concatenate([dst[mask], src[mask]]).astype(np.int64)
    key = np.unique(u_all * V + v_all)
    u_sym, col_idx = key // V, key % V
    deg = np.bincount(u_sym, minlength=V)
    row_ptr = np.zeros(V + 1, dtype=np.int64)
    np.cumsum(deg, out=row_ptr[1:])

    if max_layers is None:
        # the distance buffers are [pairs, layers]: bound the layers by
        # the BFS depth, not by V
        max_layers = _depth_bound(row_ptr, col_idx, V)
    if opt2:
        pu, pv = _similar_degree_pairs(deg, V)
    else:
        iu, iv = np.triu_indices(V, k=1)
        pu, pv = iu.astype(np.int64), iv.astype(np.int64)
    n_pairs = pu.shape[0]
    ml = min(max_layers, V)
    degree_lists = None
    if n_pairs and not opt1:
        degree_lists = _bfs_degree_lists(row_ptr, col_idx, deg, V,
                                         max_layers, opt1=False)

    pieces = {}  # layer -> list of (u, v, w f32)
    n_layers_used = 0
    for lo in range(0, n_pairs, PAIR_CHUNK):
        hi = min(lo + PAIR_CHUNK, n_pairs)
        pu_c, pv_c = pu[lo:hi], pv[lo:hi]
        if opt1:
            dist_c, nlay_c = native.struc2vec_distances(
                row_ptr, col_idx, pu_c, pv_c, ml, workers=workers,
                dtw_mode=dtw_mode, early_stop=dtw_early_stop)
        else:
            dist_c, nlay_c = _python_distances(
                degree_lists, pu_c, pv_c, ml, opt1, dtw_mode, dtw_early_stop)
        k_max = int(nlay_c.max())
        n_layers_used = max(n_layers_used, k_max)
        for k in range(k_max):
            sel = nlay_c > k
            pieces.setdefault(k, []).append(
                (pu_c[sel], pv_c[sel],
                 np.exp(-dist_c[sel, k]).astype(np.float32)))
        del dist_c, nlay_c  # free the chunk buffer before the next

    layer_edges = []
    for k in range(n_layers_used):
        us, vs, ws = zip(*pieces.pop(k))
        layer_edges.append((np.concatenate(us), np.concatenate(vs),
                            np.concatenate(ws)))
    return layer_edges, n_layers_used


def build_layer_csr(layer_edges, num_nodes):
    """Stack per-layer CSRs, alias tables and gamma into padded arrays.

    `layer_edges[k]` is a (u, v, w) array triple (u < v, one entry per
    undirected edge) as `build_context_graph` returns it. Returns a dict of
    numpy arrays: row_ptr [K, V+1] i32; col_idx, accept, alias [K, E_max]
    (E_max at least 1; pads col 0, accept 1, alias 0); gamma [K, V] f32,
    each vertex's count of edges heavier than its layer's mean.
    """
    K = len(layer_edges)
    V = num_nodes
    row_ptrs, cols, accepts, aliases, gammas = [], [], [], [], []
    e_max = 1
    for k in range(K):
        eu, ev, ew = layer_edges[k]
        eu = np.asarray(eu, dtype=np.int64)
        ev = np.asarray(ev, dtype=np.int64)
        ew = np.asarray(ew, dtype=np.float64)
        # symmetrize and sort into a CSR (neighbors sorted per row)
        U = np.concatenate([eu, ev])
        C = np.concatenate([ev, eu])
        W = np.concatenate([ew, ew])
        order = np.lexsort((C, U))
        U, C, W = U[order], C[order], W[order]
        rp = np.zeros(V + 1, dtype=np.int32)
        np.cumsum(np.bincount(U, minlength=V), out=rp[1:])
        avg = float(W.mean()) if W.size else 0.0
        gammas.append(np.bincount(U[W > avg], minlength=V).astype(
            np.float32))
        acc, ali = build_row_alias(rp.astype(np.int64), W)
        row_ptrs.append(rp)
        cols.append(C.astype(np.int32))
        accepts.append(acc.astype(np.float32))
        aliases.append(ali.astype(np.int32))
        e_max = max(e_max, C.shape[0])

    col_p = np.zeros((K, e_max), dtype=np.int32)
    acc_p = np.ones((K, e_max), dtype=np.float32)
    ali_p = np.zeros((K, e_max), dtype=np.int32)
    for k in range(K):
        n = cols[k].shape[0]
        col_p[k, :n] = cols[k]
        acc_p[k, :n] = accepts[k]
        ali_p[k, :n] = aliases[k]
    return {"row_ptr": np.stack(row_ptrs), "col_idx": col_p,
            "accept": acc_p, "alias": ali_p, "gamma": np.stack(gammas)}


# --------------------------------------------------------------------------- #
# device multilayer walk
# --------------------------------------------------------------------------- #


def multilayer_draw_shapes(B, length, max_moves=16):
    """`multilayer_walks`' draws: one [4 * max_moves + 2, B] an emission
    (a try's stay coin, slot, alias coin and layer coin, then the forced
    step's slot and coin)."""
    return [(4 * max_moves + 2, B)] * max(length - 1, 0)


def layer_tables(row_ptr, gamma, E):
    """What the multilayer walk reads of (layer, vertex), flat [K * V]:
    the degree and the first edge's flat slot in [K, E] (int64), the
    up-probability x / (x + 1), x = log(gamma + e) (f32), and whether the
    layer above has edges (the probe's layer clamped at K - 1)."""
    K = row_ptr.shape[0]
    dev = row_ptr.device
    rp = row_ptr.long()
    deg = rp[:, 1:] - rp[:, :-1]  # [K, V]
    first = rp[:, :-1] + E * torch.arange(K, device=dev)[:, None]
    x = torch.log(gamma + math.e)
    p_up = x / (x + 1.0)
    up_deg = deg[(torch.arange(K, device=dev) + 1).clamp(max=K - 1)]
    can_up = (torch.arange(K, device=dev)[:, None] + 1 < K) & (up_deg > 0)
    return tuple(t.reshape(-1) for t in (deg, first, p_up, can_up))


def multilayer_walks_plain(row_ptr, col_idx, accept, alias, gamma, starts,
                           generator, stay_prob, *, length, max_moves=16,
                           draws=None):
    """Biased multilayer walks (the reference's
    `BiasedWalker._exec_random_walk`), int32 [B, length] on starts' device.

    Tensors as `build_layer_csr` gives them, on one device: row_ptr [K,
    V+1], col_idx/accept/alias [K, E_max], gamma [K, V]; starts int [B].
    Every walker holds (vertex, layer) and emits one vertex a step, in
    lockstep. Before each emission it makes up to `max_moves` tries: with
    prob `stay_prob` a neighbor step in its layer through the layer's alias
    table (emitted); otherwise up a layer with prob x / (x + 1), x =
    log(gamma + e), where one exists above and the vertex has edges there,
    else down where the layer is above 0. A walker that made no step in its
    tries takes one in its final layer. A vertex with no edge in the layer
    stays.

    What depends only on (layer, vertex) is a flat [K * V] table built
    once from row_ptr (`layer_tables`). The tries run at a fixed count,
    walkers done masked, so no try waits on the host; every gather is flat
    and in bounds. The draws come from `generator`, or from `draws`
    (`multilayer_draw_shapes`; pass generator=None): the walks follow the
    JAX package's law, not its values.
    """
    K, Vp1 = row_ptr.shape
    V, E = Vp1 - 1, col_idx.shape[1]
    dev = starts.device
    deg, first, p_up, can_up = layer_tables(row_ptr, gamma, E)
    cols, acc, ali = (t.reshape(-1) for t in (col_idx, accept, alias))

    def neighbor_step(idx, v, u1, u2):
        d, flat = deg[idx], first[idx]
        slot = alias_draw(acc, ali, flat, d.clamp(min=1), u1, u2)
        nxt = cols[(flat + slot).clamp(max=K * E - 1)]
        return torch.where(d > 0, nxt, v)

    B = starts.shape[0]
    rand = Uniforms(generator, draws,
                     multilayer_draw_shapes(B, length, max_moves), dev)
    v = starts.long()
    layer = torch.zeros_like(v)
    out = torch.empty((B, length), dtype=torch.int32, device=dev)
    out[:, 0] = starts
    for step in range(1, length):
        # every uniform of the emission in one draw: 4 a try, 2 forced
        u = rand((4 * max_moves + 2, B))
        stepped = torch.zeros(B, dtype=torch.bool, device=dev)
        for i in range(max_moves):
            r, u1, u2, r2 = u[4 * i: 4 * i + 4]
            do_step = (r < stay_prob) & ~stepped
            v = torch.where(do_step, neighbor_step(layer * V + v, v, u1, u2),
                            v)
            stepped = stepped | do_step
            # a layer move for the walkers that have not stepped
            idx = layer * V + v
            go_up = (r2 <= p_up[idx]) & can_up[idx]
            go_down = (r2 > p_up[idx]) & (layer > 0)
            layer = torch.where(stepped, layer,
                                layer + go_up.long() - go_down.long())
        forced = neighbor_step(layer * V + v, v, u[-2], u[-1])
        v = torch.where(stepped, v, forced)
        out[:, step] = v.to(torch.int32)
    return out


def multilayer_walks(row_ptr, col_idx, accept, alias, gamma, starts,
                     generator, stay_prob, *, length, max_moves=16,
                     draws=None):
    """K9: the multilayer walk of `multilayer_walks_plain` (which the CPU
    runs; its arguments). On a card the per-(layer, vertex) tables
    (`layer_tables`, the plain version's own) and one launch of
    `csrc/walk.cu`'s multilayer walk, a thread a walker holding (vertex,
    layer): the same tries, layer moves and forced step, from Philox keyed
    by a seed drawn from `generator`, or from the shared `draws`
    (`multilayer_draw_shapes`; pass generator=None)."""
    name = "multilayer_walks"
    if not on_card(name, row_ptr, col_idx, accept, alias, gamma, starts):
        return multilayer_walks_plain(
            row_ptr, col_idx, accept, alias, gamma, starts, generator,
            stay_prob, length=length, max_moves=max_moves, draws=draws)
    if row_ptr.dim() != 2 or row_ptr.dtype not in (torch.int32,
                                                   torch.int64):
        raise ValueError(f"{name}: row_ptr must be int32 or int64 [K, V+1], "
                         f"got {row_ptr.dtype} {tuple(row_ptr.shape)}")
    check_tensor(name, "col_idx", col_idx, torch.int32, 2)
    check_tensor(name, "accept", accept, torch.float32, 2)
    check_tensor(name, "alias", alias, torch.int32, 2)
    check_tensor(name, "gamma", gamma, torch.float32, 2)
    K, Vp1 = row_ptr.shape
    V, E = Vp1 - 1, col_idx.shape[1]
    if (tuple(accept.shape) != (K, E) or tuple(alias.shape) != (K, E)
            or tuple(gamma.shape) != (K, V) or K * E < 1):
        raise ValueError(f"{name}: col_idx, accept and alias must be [K, E] "
                         f"with K * E >= 1 and gamma [K, V]")
    starts = walk_starts(name, starts)
    B, dev = starts.shape[0], starts.device
    draws_ptr, seed = kernel_rng(name, generator, draws,
                                 multilayer_draw_shapes(B, length,
                                                        max_moves), dev)
    out = torch.empty((B, length), dtype=torch.int32, device=dev)
    if B == 0 or length == 0:
        return out
    deg, first, p_up, can_up = layer_tables(row_ptr, gamma, E)
    kb.check(kb.library().ge_walk_multilayer(
        dev.index, deg.data_ptr(), first.data_ptr(), p_up.data_ptr(),
        can_up.data_ptr(), col_idx.data_ptr(), accept.data_ptr(),
        alias.data_ptr(), V, K * E, starts.data_ptr(), B, length, max_moves,
        stay_prob, draws_ptr, ptr_or_null(seed), out.data_ptr(),
        kb.stream_ptr(dev)), name)
    multilayer_walks.launches += 1
    return out


multilayer_walks.launches = 0


# --------------------------------------------------------------------------- #
# model
# --------------------------------------------------------------------------- #


def layers_to(layers, device):
    """`build_layer_csr`'s arrays as tensors on `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in layers.items()}


class Struc2Vec(WalkEmbeddingModel):
    # hs='auto' trains hierarchical softmax up to this many nodes, sampled
    # SGNS above, as the JAX package does
    HS_AUTO_MAX_NODES = 200_000

    def __init__(self, graph, walk_length=10, num_walks=100, workers=1,
                 verbose=0, stay_prob=0.3, opt1_reduce_len=True,
                 opt2_reduce_sim_calc=True, opt3_num_layers=None,
                 temp_path="./temp_struc2vec/", reuse=False, seed=0,
                 mesh=None, dtw_mode="fastdtw", dtw_early_stop=35.0,
                 device="cuda"):
        """The context graph is built on the host (or, with reuse=True,
        read from `temp_path`'s cache of it), then the walks are made on
        `device`, or over `mesh`. `opt3_num_layers` caps the layers (None:
        the BFS depth bound); `workers` threads the C++ distance build."""
        del verbose
        super().__init__(graph, walk_length, num_walks, seed, device, mesh)
        self.stay_prob = stay_prob

        cache_file = None
        if temp_path:
            os.makedirs(temp_path, exist_ok=True)
            h = hashlib.sha1()
            h.update(self.graph.row_ptr.tobytes())
            h.update(self.graph.col_idx.tobytes())
            h.update(f"{opt1_reduce_len}-{opt2_reduce_sim_calc}-"
                     f"{opt3_num_layers}-{dtw_mode}-{dtw_early_stop}".encode())
            cache_file = os.path.join(temp_path,
                                      f"context_{h.hexdigest()[:16]}.pkl")
        self.cache_hit = bool(reuse and cache_file
                              and os.path.exists(cache_file))
        if self.cache_hit:
            # the model's own cache, written below by an earlier run
            with open(cache_file, "rb") as f:
                layers = pickle.load(f)
        else:
            layer_edges, _ = build_context_graph(
                self.graph, max_layers=opt3_num_layers, opt1=opt1_reduce_len,
                opt2=opt2_reduce_sim_calc, workers=workers, dtw_mode=dtw_mode,
                dtw_early_stop=dtw_early_stop)
            layers = build_layer_csr(layer_edges, self.graph.num_nodes)
            if cache_file:
                with open(cache_file, "wb") as f:
                    pickle.dump(layers, f)
        self.layers = layers_to(layers, self.device)
        if mesh is not None:
            self.walks = self._mesh_walks(
                None, kind="multilayer", stay_prob=stay_prob,
                layers=layers, num_nodes=self.graph.num_nodes)
        else:
            self.walks = self.simulate_walks()

    def simulate_walks(self, seed=None):
        """num_walks multilayer walks from every node (walk i starts at
        node i % V) from `seed` (default the model's)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.seed if seed is None else seed)
        starts = torch.arange(self.graph.num_nodes, dtype=torch.int32,
                              device=self.device).repeat(self.num_walks)
        ly = self.layers
        return multilayer_walks(ly["row_ptr"], ly["col_idx"], ly["accept"],
                                ly["alias"], ly["gamma"], starts, gen,
                                self.stay_prob, length=self.walk_length)

    def train(self, embed_size=128, window_size=5, workers=None, iter=5,
              hs="auto", **kwargs):
        """hs='auto' (the default): hierarchical softmax, the reference's
        `Word2Vec(sg=1, hs=1)` objective, up to HS_AUTO_MAX_NODES nodes,
        sampled SGNS above. An explicit hs=1 or hs=0 wins."""
        if hs == "auto":
            hs = 1 if self.graph.num_nodes <= self.HS_AUTO_MAX_NODES else 0
        return self._fit_skipgram(embed_size=embed_size,
                                  window_size=window_size, workers=workers,
                                  iter=iter, hs=hs, **kwargs)
