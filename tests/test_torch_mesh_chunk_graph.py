"""The mesh trainers' chunks as one graph (`train/chunk_graph.py` under
`parallel/`) on the CPU, at world size 1 and 2.

Over NCCL each chunk of a mesh trainer's steps replays one captured CUDA
graph, its exchanges inside it. Here the ranks are gloo processes on CPU
tensors, whose exchanges are not staged through the host, so the chunks
take the graph path, and a stand-in for the CUDA capture
(`test_torch_chunk_graph.StandInCapture`) runs the captured body on the
graph's buffers at every replay. Each chunk is held bit for bit
(torch.equal: tables, losses, pairs) against the mesh loop as it was
before the graphs (`*_loop` below), and so is the same chunk launched one
by one without the stand-in: the rowshard chunk with prefetch off and on,
the dp chunk at (1, 1), (2, 1) and (1, 2), the HS dp chunk at (n, 1) and
(1, 2), the LINE dp chunk (orders 'first' and 'second'), and SDNE's
full-batch and sparse mesh trainers (in chunks of epochs between
checkpoints, and in one). Each runs three chunks of its kind (one
wrapping around the corpus' blocks), captured once and replayed. Also: a
rowshard fit and an SDNE mesh train cut and resumed through the stand-in
equal uninterrupted ones and the loop; the backend rule (gloo with tensors
off the CPU runs the loop; NCCL and gloo on CPU tensors take the graph);
the cache never replays a graph under a group other than the one it was
captured with, `release(group=)` drops only that group's graphs, and
`destroy_distributed` releases the graphs of the groups before it
leaves them.

One spawn a world size (`mesh_cases`, one torch thread a rank) runs every
case; each test reads its own. No jax here: the spawned ranks import this
module.
"""

import os

import numpy as np
import pytest
import torch

from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.parallel.launch import run_ranks
from graphembedding_tpu_torch.train import chunk_graph as cg

from test_torch_chunk_graph import StandInCapture

WORLDS = (1, 2)
V, D, L, NW, BW, K, W, NSP, CAP = 41, 16, 8, 96, 32, 6, 3, 2, 8.0
# three blocks of the corpus; chunks of S = 3 steps from t0 = 0, 2 and 4,
# so each of the last two wraps around them
S, T0S, TOTAL = 3, (0, 2, 4), 12.0


# ---- the mesh loops as they were before the chunk graphs ---------------

def rowshard_loop(w_local, walks, eff, negs, alpha, min_alpha, t0,
                  total_steps, *, mesh, block_walks, window, negative,
                  neg_share_packs=4, update_cap=8.0, prefetch=False):
    from graphembedding_tpu_torch.parallel import rowshard as rs
    from graphembedding_tpu_torch.train import skipgram as tsg

    group = mesh.get_group("data")
    n, di = mesh.size("data"), mesh.get_local_rank("data")
    NW_, L_ = walks.shape
    Vp, C = w_local.shape
    D_ = C // 2
    lo = di * Vp
    geo = rs.rank_geometry(NW_, L_, block_walks, n, neg_share_packs)
    S_, K_ = eff.shape[0], negs.shape[2]
    window_ok, dm = tsg.window_geometry(L_, geo.PL, window, walks.device)
    lrs = tsg.step_lrs(t0, S_, alpha, min_alpha, total_steps)
    offs = rs.block_offsets(t0, S_, geo, n, di)
    neg_w = float(np.float32(negative) / np.float32(K_))
    Tt = geo.G * geo.PL

    def ids_of(s):
        tok = walks[offs[s]: offs[s] + geo.Bw].reshape(geo.G, geo.PL)
        ids = torch.cat([tok.reshape(-1), negs[s].reshape(-1)])
        return (tok, ids) + rs.gather_ids(ids, lo, Vp, group)

    def fetch(ex):
        return rs.fetch_rows_with(w_local, ex[1], ex[2], ex[3], group)

    def step(ex, rows, s):
        tok, _, local, owned = ex
        _, mask, neg_ok = tsg.step_masks(tok, eff[s], negs[s], window_ok,
                                         dm, geo.nsp)
        y = rows[:Tt].view(geo.G, geo.PL, C)
        vn = rows[Tt:, D_:].view(geo.G2, K_, D_)
        d_yin, d_yout, d_vn, loss_g = tsg.KERNELS.grads(
            y[..., :D_], y[..., D_:], vn, mask, neg_ok, neg_w)
        d_tok, d_neg = tsg.event_rows(d_yin, d_yout, d_vn, mask, neg_w)
        tbuf = rs.push_grads_with(Vp, local[:, :Tt], owned[:, :Tt], d_tok,
                                  group)
        if lo == 0:
            tbuf[0, C] += (local[:, :Tt] < 0).sum()
        nbuf = rs.push_grads_with(Vp, local[:, Tt:], owned[:, Tt:], d_neg,
                                  group)
        tsg.capped_update(w_local, tbuf, nbuf, float(lrs[s]),
                          float(update_cap))
        pairs = mask.sum()
        return torch.stack([loss_g.sum(), pairs.clamp(min=1.0), pairs])

    stats = []
    ex = ids_of(0)
    rows = fetch(ex)
    for s in range(S_):
        if prefetch and s + 1 < S_:
            ex_n = ids_of(s + 1)
            rows_n = fetch(ex_n)
        stats.append(step(ex, rows, s))
        if s + 1 < S_:
            if prefetch:
                ex, rows = ex_n, rows_n
            else:
                ex = ids_of(s + 1)
                rows = fetch(ex)
    stats = comm.all_reduce(torch.stack(stats), group)
    return w_local, stats[:, 0] / stats[:, 1], stats[:, 2]


def dp_loop(w_cat, walks, eff, negs, alpha, min_alpha, t0, total_steps, *,
            mesh, block_walks, window, negative, neg_share_packs=4,
            update_cap=8.0, sync_every=None):
    import functools

    from graphembedding_tpu_torch.ops.sgns import sgns_block_grads_plain
    from graphembedding_tpu_torch.parallel import sgns
    from graphembedding_tpu_torch.train import skipgram as tsg
    from graphembedding_tpu_torch.utils.precision import f32_matmul

    data, model = mesh.get_group("data"), mesh.get_group("model")
    n, di = mesh.size("data"), mesh.get_local_rank("data")
    NW_, L_ = walks.shape
    geo = sgns.dp_geometry(NW_, L_, block_walks, n, neg_share_packs)
    S_, K_ = eff.shape[0], negs.shape[2]
    sync_every = min(sync_every or sgns.DEFAULT_SYNC_EVERY, S_)
    ops = tsg.KERNELS
    if mesh.size("model") > 1:
        ops = ops._replace(grads=functools.partial(
            sgns_block_grads_plain,
            reduce=functools.partial(comm.all_reduce, group=model)))
    window_ok, dm = tsg.window_geometry(L_, geo.PL, window, walks.device)
    lrs = tsg.step_lrs(t0, S_, alpha, min_alpha, total_steps)
    offs = sgns.dp_offsets(t0, S_, geo, block_walks, n, di)
    neg_w = float(np.float32(negative) / np.float32(K_))
    w_base = w_cat.clone()
    losses, pairs = [], []
    with f32_matmul():
        for s in range(S_):
            tok = walks[offs[s]: offs[s] + geo.Bw].reshape(geo.G, geo.PL)
            loss, p = tsg.sgns_step(
                w_cat, tok, eff[s], negs[s], float(lrs[s]),
                window_ok=window_ok, dm=dm, nsp=geo.nsp, neg_w=neg_w,
                update_cap=float(update_cap), ops=ops)
            losses.append(loss)
            pairs.append(p)
            if (s + 1) % sync_every == 0:
                sgns.sync_replicas([w_cat], [w_base], data)
    sgns.sync_replicas([w_cat], [w_base], data)
    stats = comm.all_reduce(torch.stack([torch.stack(losses),
                                         torch.stack(pairs)]), data)
    return w_cat, stats[0] / n, stats[1]


def hs_loop(w_in, w_tree, walks, points, codes, eff, alpha, min_alpha, t0,
            total_steps, *, mesh, block_walks, window, update_cap=8.0,
            sync_every=None):
    import functools

    from graphembedding_tpu_torch.parallel import sgns
    from graphembedding_tpu_torch.train import skipgram as tsg
    from graphembedding_tpu_torch.train.hsoftmax import hs_step
    from graphembedding_tpu_torch.utils.precision import f32_matmul

    data, model = mesh.get_group("data"), mesh.get_group("model")
    n, di = mesh.size("data"), mesh.get_local_rank("data")
    NW_, L_ = walks.shape
    geo = sgns.dp_geometry(NW_, L_, block_walks, n, 1)
    S_ = eff.shape[0]
    sync_every = min(sync_every or sgns.DEFAULT_SYNC_EVERY, S_)
    reduce = (functools.partial(comm.all_reduce, group=model)
              if mesh.size("model") > 1 else None)
    window_ok, dm = tsg.window_geometry(L_, geo.PL, window, walks.device)
    lrs = tsg.step_lrs(t0, S_, alpha, min_alpha, total_steps)
    offs = sgns.dp_offsets(t0, S_, geo, block_walks, n, di)
    tables = [w_in, w_tree]
    bases = [w_in.clone(), w_tree.clone()]
    losses, pairs = [], []
    with f32_matmul():
        for s in range(S_):
            tok = walks[offs[s]: offs[s] + geo.Bw].reshape(geo.G, geo.PL)
            loss, p = hs_step(w_in, w_tree, tok, eff[s], points, codes,
                              float(lrs[s]), window_ok=window_ok, dm=dm,
                              update_cap=float(update_cap), reduce=reduce)
            losses.append(loss)
            pairs.append(p)
            if (s + 1) % sync_every == 0:
                sgns.sync_replicas(tables, bases, data)
    sgns.sync_replicas(tables, bases, data)
    stats = comm.all_reduce(torch.stack([torch.stack(losses),
                                         torch.stack(pairs)]), data)
    return w_in, w_tree, stats[0] / n, stats[1]


def line_loop(emb, ctx, hs, tposs, tnegs, lrs, *, mesh, negative,
              k_shared=0, update_cap=8.0, sync_every=None):
    from graphembedding_tpu_torch.models.line import line_step
    from graphembedding_tpu_torch.parallel import sgns

    group, n = mesh.get_group("data"), mesh.size("data")
    S_ = hs.shape[0]
    sync_every = min(sync_every or sgns.DEFAULT_SYNC_EVERY, S_)
    tables = [emb] if ctx is None else [emb, ctx]
    bases = [t.clone() for t in tables]
    losses = []
    for s in range(S_):
        losses.append(line_step(emb, ctx, hs[s], tposs[s], tnegs[s], lrs[s],
                                negative=negative, k_shared=k_shared,
                                update_cap=update_cap))
        if (s + 1) % sync_every == 0:
            sgns.sync_replicas(tables, bases, group)
    sgns.sync_replicas(tables, bases, group)
    return emb, ctx, comm.all_reduce(torch.stack(losses), group) / n


def sdne_loop(m, mesh, mode, epochs):
    """SDNE's mesh trainers as a loop of steps on the module: this rank's
    loss, its gradients summed over the data axis in one flat buffer, then
    `Adam.step`. Returns the summed losses."""
    from torch.utils.checkpoint import checkpoint

    from graphembedding_tpu_torch.models import sdne as tsdne
    from graphembedding_tpu_torch.ops.spmm import spmm
    from graphembedding_tpu_torch.parallel import sdne as psdne

    net, group = m.net, mesh.get_group("data")
    rank, n, Vn = mesh.get_local_rank("data"), mesh.size("data"), \
        m.graph.num_nodes
    m._on_mesh(mesh)
    opt = m._adam(1e-3)
    if mode == "full":
        a_rows, l_rows, ok = psdne.shard_dense(m.A, m.L, mesh, Vn)

        def loss_local():
            y = net.encode(a_rows)
            a_hat = net.decode(y)
            b_ = torch.where(a_rows != 0, m.beta, 1.0)
            l2nd = (((a_rows - a_hat) * b_).square().sum(-1) * ok).sum() / Vn
            y_full = psdne.all_gather_rows(y, group, rank)
            l1st = m.alpha * 2.0 * (y * (l_rows @ y_full)).sum() / Vn
            return l2nd + l1st + tsdne.weight_penalty(net, m.nu1, m.nu2) / n
    else:
        A, At, S_, St, deg_w, nbr, nbr_w = psdne.pad_sparse_inputs(
            m.graph, mesh, "cpu")

        def loss_local():
            first = net.enc[0]
            y = tsdne.run_stack(net.enc[1:], torch.relu(
                spmm(A, first.w, At) + first.b))
            y_full = psdne.all_gather_rows(y, group, rank)
            l1st = m.alpha * 2.0 * ((deg_w[:, None] * y.square()).sum()
                                    - (y * spmm(S_, y_full, St)).sum()) / Vn
            l2nd = 0.0
            for lo in range(0, nbr.shape[0], 16):
                hi = min(lo + 16, nbr.shape[0])
                l2nd = l2nd + checkpoint(
                    tsdne.chunk_reconstruction, net, y[lo:hi], nbr[lo:hi],
                    nbr_w[lo:hi], m.beta, use_reentrant=False,
                    preserve_rng_state=False)
            return (l2nd / Vn + l1st
                    + tsdne.weight_penalty(net, m.nu1, m.nu2) / n)

    losses = []
    with tsdne.f32_matmul():
        for _ in range(epochs):
            loss_l = loss_local()
            names, params = zip(*net.named_parameters())
            grads = torch.autograd.grad(loss_l, params)
            flat = comm.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                   group)
            summed, off = {}, 0
            for k, p in zip(names, params):
                summed[k] = flat[off:off + p.numel()].view_as(p)
                off += p.numel()
            opt.step(summed)
            losses.append(comm.all_reduce(loss_l.detach(), group))
    return torch.stack(losses)


# ---- the cases, in each spawned rank --------------------------------------

class Captures:
    """The stand-in capture under `chunk_graph.CAPTURES`, counting the
    captures it made."""

    def __init__(self):
        self.made = 0

    def __call__(self, device):
        self.made += 1
        return StandInCapture(device)


def through_stand_in(fn):
    """fn() with the CPU's chunks on the graph path (the cache emptied
    before and after); returns (fn's result, captures made)."""
    cap = Captures()
    cg.release()
    cg.CAPTURES["cpu"] = cap
    try:
        return fn(), cap.made
    finally:
        del cg.CAPTURES["cpu"]
        cg.release()


def equal(a, b):
    return len(a) == len(b) and all(
        (x is None and y is None) or torch.equal(x, y) for x, y in zip(a, b))


def held(init, run_new, run_loop):
    """run_new() through the stand-in and launched one by one, against
    run_loop() (the pre-graph loop); each returns a list of tensors, the
    first a table that started at `init`."""
    graph, captures = through_stand_in(run_new)
    want = run_loop()
    return dict(graph=equal(graph, want), loop=equal(run_new(), want),
                captures=captures, moved=not torch.equal(graph[0], init))


def corpus():
    """NW walks of L over V nodes, the same on every rank; one in ten
    stops early (-1 pads)."""
    rng = np.random.default_rng(0)
    walks = rng.integers(0, V, (NW, L)).astype(np.int32)
    stop = np.where(rng.random(NW) < 0.1, rng.integers(1, L, NW), L)
    walks[np.arange(L)[None, :] >= stop[:, None]] = -1
    return torch.from_numpy(walks)


def sgns_table(rows, seed):
    gen = torch.Generator().manual_seed(seed)
    return torch.cat([(torch.rand((rows, D), generator=gen) - 0.5) / D,
                      torch.randn((rows, D), generator=gen) * 0.1], 1)


def _rowshard(mesh, prefetch):
    from graphembedding_tpu_torch.parallel.rowshard import (
        rank_geometry,
        rowsharded_sgns_chunk,
    )
    from graphembedding_tpu_torch.train.skipgram import window_draws

    n, di = mesh.size("data"), mesh.get_local_rank("data")
    walks = corpus()
    geo = rank_geometry(NW, L, BW, n, NSP)
    Vp = -(-V // n)
    w0 = sgns_table(n * Vp, 1)[di * Vp:(di + 1) * Vp].clone()
    gen = torch.Generator().manual_seed(10 + di)  # this rank's draws
    draws = [(t0, window_draws(gen, (S, geo.G, geo.PL), W),
              torch.randint(0, V, (S, geo.G2, K), generator=gen,
                            dtype=torch.int32)) for t0 in T0S]
    kw = dict(mesh=mesh, block_walks=BW, window=W, negative=5,
              neg_share_packs=NSP, update_cap=CAP, prefetch=prefetch)

    def run(chunk):
        w, out = w0.clone(), []
        for t0, eff, negs in draws:
            out += chunk(w, walks, eff, negs, 0.025, 1e-4, t0, TOTAL,
                         **kw)[1:]
        return [w, *out]
    return held(w0, lambda: run(rowsharded_sgns_chunk),
                lambda: run(rowshard_loop))


def _cols(mesh, table):
    """This model rank's columns of each half of a [rows, 2 * D] table."""
    m, mi = mesh.size("model"), mesh.get_local_rank("model")
    Dl = D // m
    return torch.cat([table[:, mi * Dl:(mi + 1) * Dl],
                      table[:, D + mi * Dl:D + (mi + 1) * Dl]], 1)


def _dp(mesh):
    from graphembedding_tpu_torch.parallel.sgns import (
        dp_geometry,
        sharded_sgns_chunk,
    )
    from graphembedding_tpu_torch.train.skipgram import window_draws

    n, di = mesh.size("data"), mesh.get_local_rank("data")
    walks = corpus()
    geo = dp_geometry(NW, L, BW, n, NSP)
    w0 = _cols(mesh, sgns_table(V, 2))
    shared = torch.Generator().manual_seed(20)
    ranked = torch.Generator().manual_seed(30 + di)
    draws = [(t0, window_draws(shared, (S, geo.G, geo.PL), W),
              torch.randint(0, V, (S, geo.G2, K), generator=ranked,
                            dtype=torch.int32)) for t0 in T0S]
    kw = dict(mesh=mesh, block_walks=BW, window=W, negative=5,
              neg_share_packs=NSP, update_cap=CAP, sync_every=2)

    def run(chunk):
        w, out = w0.clone(), []
        for t0, eff, negs in draws:
            out += chunk(w, walks, eff, negs, 0.025, 1e-4, t0, TOTAL,
                         **kw)[1:]
        return [w, *out]
    return held(w0, lambda: run(sharded_sgns_chunk), lambda: run(dp_loop))


def _hs(mesh):
    from graphembedding_tpu_torch.parallel.hsoftmax import sharded_hs_chunk
    from graphembedding_tpu_torch.parallel.sgns import dp_geometry
    from graphembedding_tpu_torch.train.hsoftmax import build_huffman
    from graphembedding_tpu_torch.train.skipgram import (
        corpus_counts,
        window_draws,
    )

    n, di = mesh.size("data"), mesh.get_local_rank("data")
    walks = corpus()
    geo = dp_geometry(NW, L, BW, n, 1)
    points, codes, _ = build_huffman(corpus_counts(walks, V))
    points, codes = torch.from_numpy(points), torch.from_numpy(codes)
    cols = _cols(mesh, sgns_table(V, 3))
    Dl = cols.shape[1] // 2
    w_in0, w_tree0 = cols[:, :Dl].clone(), cols[:V - 1, Dl:].clone()
    gen = torch.Generator().manual_seed(40 + di)
    draws = [(t0, window_draws(gen, (S, geo.G, geo.PL), W)) for t0 in T0S]

    def run(chunk):
        w_in, w_tree, out = w_in0.clone(), w_tree0.clone(), []
        for t0, eff in draws:
            out += chunk(w_in, w_tree, walks, points, codes, eff, 0.025,
                         1e-4, t0, TOTAL, mesh=mesh, block_walks=BW,
                         window=W, update_cap=2.0, sync_every=2)[2:]
        return [w_in, w_tree, *out]
    return held(w_in0, lambda: run(sharded_hs_chunk), lambda: run(hs_loop))


def _line(mesh, order):
    from graphembedding_tpu_torch.models.line import line_bulk_samples
    from graphembedding_tpu_torch.parallel.line import sharded_line_chunk

    di = mesh.get_local_rank("data")
    gen = torch.Generator().manual_seed(50)
    emb0 = torch.randn((V, D), generator=gen) * 0.1
    ctx0 = None if order == "first" else torch.randn((V, D),
                                                     generator=gen) * 0.1
    E = 60
    edges = (torch.randint(0, V, (E,), generator=gen, dtype=torch.int32),
             torch.randint(0, V, (E,), generator=gen, dtype=torch.int32),
             torch.rand((E,), generator=gen),
             torch.randint(0, E, (E,), generator=gen))
    neg_table = torch.randint(0, V, (256,), generator=gen, dtype=torch.int32)
    k_shared = 0 if order == "first" else 10
    ranked = torch.Generator().manual_seed(60 + di)
    draws = [line_bulk_samples(*edges, neg_table, ranked, 0.025, S * c,
                               S * 3.0, chunk_steps=S, batch_size=8,
                               negative=5, k_shared=k_shared)
             for c in range(3)]

    def run(chunk):
        emb = emb0.clone()
        ctx = None if ctx0 is None else ctx0.clone()
        out = []
        for d in draws:
            out.append(chunk(emb, ctx, *d, mesh=mesh, negative=5,
                             k_shared=k_shared, sync_every=2)[2])
        return [emb, ctx, *out]
    return held(emb0, lambda: run(sharded_line_chunk),
                lambda: run(line_loop))


def sdne_graph():
    from graphembedding_tpu_torch.data import datasets as tds

    return tds.synthetic_wiki(num_nodes=45, num_classes=3, avg_degree=4,
                              seed=3).graph


def _sdne(mesh, mode, tmp):
    from graphembedding_tpu_torch import SDNE

    g = sdne_graph()
    train = {"full": lambda m, **k: m.train(batch_size=100, epochs=5,
                                            mesh=mesh, **k),
             "sparse": lambda m, **k: m.train_sparse(
                 epochs=5, row_chunk=16, mesh=mesh, **k)}[mode]

    def params(m):
        return [p.detach().clone() for p in m.net.parameters()]

    ref = SDNE(g, hidden_size=[12, 6], device="cpu")
    init = params(ref)
    losses = sdne_loop(ref, mesh, mode, 5)
    want = [*params(ref), losses]
    runs = iter(range(4))
    out = {}
    # in chunks of 2, 2 and 1 epochs (a checkpoint each), and in one
    for name, every in (("chunks", 2), ("one", 0)):
        def run():
            m = SDNE(g, hidden_size=[12, 6], device="cpu")
            kw = {} if not every else dict(
                checkpoint_dir=f"{tmp}/{mode}_{next(runs)}",
                checkpoint_every=every)
            train(m, **kw)
            return [*params(m), m.losses]
        graph, captures = through_stand_in(run)
        out[name] = dict(graph=equal(graph, want), loop=equal(run(), want),
                         captures=captures,
                         moved=not torch.equal(graph[0], init[0]))
    return out


class _Cut(Exception):
    pass


class _CutAfter:
    """A metrics logger that raises once a chunk past `step` ran."""

    def __init__(self, step):
        self.step = step

    def log(self, **kw):
        if kw["step"] > self.step:
            raise _Cut()


def _resumes(mesh, tmp):
    """A rowshard fit and an SDNE full-batch mesh train, each cut after its
    first chunk and resumed from its checkpoint through the stand-in,
    against the uninterrupted run through the stand-in and the loop."""
    from graphembedding_tpu_torch import SDNE
    from graphembedding_tpu_torch.models import sdne as tsdne
    from graphembedding_tpu_torch.parallel import DistributedSkipGramTrainer
    from graphembedding_tpu_torch.train.skipgram import SkipGramConfig

    walks = corpus()
    cfg = SkipGramConfig(embed_size=8, epochs=2, chunk_steps=2,
                         block_walks=BW)

    def fit(**kw):
        return list(DistributedSkipGramTrainer(mesh, cfg).fit(walks, V,
                                                              **kw))

    def cut_and_resumed():
        ck = f"{tmp}/rowshard_ck"
        try:
            fit(checkpoint_dir=ck, checkpoint_every=1,
                metrics=_CutAfter(cfg.chunk_steps))
        except _Cut:
            pass
        return fit(checkpoint_dir=ck)

    whole, _ = through_stand_in(fit)
    resumed, captures = through_stand_in(cut_and_resumed)
    loop = fit()
    out = dict(rowshard=dict(
        graph=equal(whole, loop), resumed=equal(resumed[:2], whole[:2]),
        resumed_losses=torch.equal(resumed[2], whole[2][cfg.chunk_steps:]),
        captures=captures, steps=whole[2].shape[0]))

    g = sdne_graph()

    def train(**kw):
        m = SDNE(g, hidden_size=[12, 6], device="cpu")
        m.train(batch_size=100, epochs=5, mesh=mesh, **kw)
        return [*(p.detach().clone() for p in m.net.parameters()), m.losses]

    def sdne_cut_and_resumed():
        ck = f"{tmp}/sdne_ck"
        chunk, calls = tsdne.adam_chunk, []

        def cut(*a, **k):
            calls.append(1)
            if len(calls) == 2:
                raise _Cut()
            return chunk(*a, **k)

        tsdne.adam_chunk = cut
        try:
            train(checkpoint_dir=ck, checkpoint_every=2)
        except _Cut:
            pass
        finally:
            tsdne.adam_chunk = chunk
        return train(checkpoint_dir=ck, checkpoint_every=2)

    whole, _ = through_stand_in(lambda: train(
        checkpoint_dir=f"{tmp}/sdne_whole", checkpoint_every=2))
    resumed, captures = through_stand_in(sdne_cut_and_resumed)
    loop = train()
    out["sdne"] = dict(
        graph=equal(whole, loop), resumed=equal(resumed[:-1], whole[:-1]),
        resumed_losses=torch.equal(resumed[-1], whole[-1][2:]),
        captures=captures, steps=whole[-1].shape[0])
    return out


def summing_step(b, s, ops, *, group):
    """Adds the group's sum of b["x"][s] to b["t"]."""
    b["t"].add_(comm.all_reduce(b["x"][s], group))
    return (b["t"].sum(),)


def adding_step(b, s, ops):
    """Adds 1 to b["t"]; no exchange."""
    b["t"].add_(1.0)
    return (b["t"].sum(),)


def _rule_and_groups(mesh):
    """The backend rule on this gloo group, and the cache by group."""
    import torch.distributed as dist

    from graphembedding_tpu_torch.parallel import mesh as pmesh

    group = mesh.get_group("data")
    out = dict(staged_cpu=comm.host_staged(group, "cpu"),
               staged_cuda=comm.host_staged(group, "cuda:0"),
               staged_meta=comm.host_staged(group, "meta"))
    # tensors off the CPU over gloo: the loop, though "meta" could capture
    cap = Captures()
    cg.CAPTURES["meta"] = cap
    try:
        cg.run_chunk(adding_step, 2, {"t": torch.zeros(3, device="meta")},
                     {}, groups=(group,))
        out["meta_captures"] = cap.made
    finally:
        del cg.CAPTURES["meta"]

    # a graph a group: two groups of the same ranks
    ranks = list(range(dist.get_world_size()))
    g1, g2 = dist.new_group(ranks), dist.new_group(ranks)
    cap = Captures()
    cg.release()
    cg.CAPTURES["cpu"] = cap
    t = torch.zeros(3)
    x = torch.arange(6.0).view(2, 3) + dist.get_rank()
    try:
        for g in (g1, g1, g2, g1):
            cg.run_chunk(summing_step, 2, {"t": t}, {"x": x},
                         consts={"group": g}, groups=(g,))
        out["captures"] = cap.made
        out["t"] = t.clone()
        out["held"] = (len(cg.held("cpu", g1)), len(cg.held("cpu", g2)),
                       len(cg.held()))
        cg.release(group=g1)
        out["after_release"] = (len(cg.held(group=g1)),
                                len(cg.held(group=g2)), len(cg.held()))
        # a graph of no group, then destroy_distributed with the group
        # destroy itself stood in for: only the groups' graphs go
        cg.run_chunk(summing_step, 2, {"t": t}, {"x": x},
                     consts={"group": g1}, groups=(g1,))
        cg.run_chunk(adding_step, 2, {"t": t}, {})
        destroyed = []
        real = dist.destroy_process_group
        dist.destroy_process_group = lambda: destroyed.append(
            len(cg.held()))
        try:
            pmesh.destroy_distributed()
        finally:
            dist.destroy_process_group = real
        out["destroyed"] = destroyed
    finally:
        del cg.CAPTURES["cpu"]
        cg.release()
    return out


def mesh_cases(info, tmp):
    from graphembedding_tpu_torch.parallel import make_mesh

    n = info.world_size
    tmp = os.path.join(tmp, f"rank{info.rank}")
    os.makedirs(tmp, exist_ok=True)
    meshes = {"n1": make_mesh((n, 1), device="cpu")}
    if n > 1:
        meshes["1n"] = make_mesh((1, n), device="cpu")
    mesh = meshes["n1"]
    out = {f"rowshard_p{int(p)}": _rowshard(mesh, p) for p in (False, True)}
    for shape, m in meshes.items():
        out[f"dp_{shape}"] = _dp(m)
        out[f"hs_{shape}"] = _hs(m)
    for order in ("first", "second"):
        out[f"line_{order}"] = _line(mesh, order)
    for mode in ("full", "sparse"):
        for name, res in _sdne(mesh, mode, tmp).items():
            out[f"sdne_{mode}_{name}"] = res
    out["resumes"] = _resumes(mesh, tmp)
    out["rule_groups"] = _rule_and_groups(mesh)
    return out


# ---- the checks ------------------------------------------------------------

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case, at each world size: {n: [rank 0's, rank 1's, ...]}."""
    return {n: run_ranks(mesh_cases, n, str(tmp_path_factory.mktemp(
        f"world{n}")), timeout_s=600) for n in WORLDS}


# (n, 1) at world 1 is the (1, 1) mesh; (1, n) is a model axis of 2
CHUNKS = [(n, case) for n in WORLDS for case in (
    "rowshard_p0", "rowshard_p1", "dp_n1", "hs_n1", "line_first",
    "line_second")] + [(2, "dp_1n"), (2, "hs_1n")]


@pytest.mark.parametrize("n,case", CHUNKS)
def test_mesh_chunk_through_graph_equals_the_loop(results, n, case):
    """Three chunks through the stand-in (one capture, two replays) and
    launched one by one, each torch.equal to the pre-graph mesh loop on
    every rank; the table moved."""
    for r, res in enumerate(results[n]):
        got = res[case]
        assert got["graph"], (r, case)
        assert got["loop"], (r, case)
        assert got["captures"] == 1 and got["moved"], (r, got)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", ["full", "sparse"])
@pytest.mark.parametrize("chunks", ["chunks", "one"])
def test_sdne_mesh_train_through_graph_equals_the_loop(results, n, mode,
                                                       chunks):
    """SDNE's mesh trainers, 5 epochs in chunks of 2, 2 and 1 (a
    checkpoint each: a graph for 2 steps, one for 1) or in one chunk,
    through the stand-in and launched one by one: parameters and summed
    losses torch.equal to the pre-graph loop of steps."""
    for r, res in enumerate(results[n]):
        got = res[f"sdne_{mode}_{chunks}"]
        assert got["graph"] and got["loop"] and got["moved"], (r, got)
        assert got["captures"] == (2 if chunks == "chunks" else 1)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("kind", ["rowshard", "sdne"])
def test_resumed_mesh_fit_through_graph_equals_uninterrupted(results, n,
                                                             kind):
    """A rowshard fit (2 epochs of 3 chunks of 2 steps) cut after its first
    chunk, and an SDNE full-batch mesh train (5 epochs, a checkpoint every
    2) cut in its second chunk, each resumed from its checkpoints through
    the stand-in in a fresh model: tables equal to the uninterrupted run
    through the stand-in, which equals the loop; the resumed run's losses
    are the uninterrupted run's last."""
    for r, res in enumerate(results[n]):
        got = res["resumes"][kind]
        assert got["graph"] and got["resumed"], (r, got)
        assert got["resumed_losses"], (r, got)
        assert got["captures"] >= 1 and got["steps"] > 2


@pytest.mark.parametrize("n", WORLDS)
def test_backend_rule_on_gloo_groups(results, n):
    """Gloo stages an exchange of a tensor off the CPU through the host:
    a chunk whose tables lie there runs its steps one by one even where
    its device type could capture; on CPU tensors it is not staged."""
    for res in results[n]:
        got = res["rule_groups"]
        assert not got["staged_cpu"]
        assert got["staged_cuda"] and got["staged_meta"]
        assert got["meta_captures"] == 0


@pytest.mark.parametrize("backend,device,staged", [
    ("gloo", "cpu", False), ("gloo", "cuda", True), ("gloo", "cuda:1", True),
    ("nccl", "cuda", False), ("nccl", "cuda:0", False)])
def test_host_staged_by_backend(monkeypatch, backend, device, staged):
    """The rule itself: host-staged exactly for gloo with a tensor off the
    CPU (no card or process group needed)."""
    monkeypatch.setattr(comm.dist, "get_backend", lambda group: backend)
    assert comm.host_staged(None, device) is staged
    assert comm.host_staged(None, torch.device(device)) is staged


@pytest.mark.parametrize("n", WORLDS)
def test_graph_never_replays_under_another_group(results, n):
    """Chunks over groups g1, g1, g2, g1 of the same ranks: two captures
    (g1's replayed, g2 captured apart), the sums as the loop's;
    `release(group=g1)` drops g1's graph only; `destroy_distributed`
    releases the groups' graphs before leaving, and keeps a graph of no
    group."""
    for r, res in enumerate(results[n]):
        got = res["rule_groups"]
        assert got["captures"] == 2
        # four chunks of two steps, each adding n * x[s] + the ranks' sum
        x = torch.arange(6.0).view(2, 3)
        want = 4 * (n * (x[0] + x[1]) + 2 * sum(range(n)))
        assert torch.equal(got["t"], want), (r, got["t"], want)
        assert got["held"] == (1, 1, 2)
        assert got["after_release"] == (0, 1, 1)
        assert got["destroyed"] == [1]  # the graph of no group left
