"""A chunk of steps as one graph (`train/chunk_graph.py`) on the CPU.

On a card `sgns_block_chunk_cat`, `hs_block_chunk` and `line_steps` replay
one captured CUDA graph a chunk: the step function runs on buffers the
graph owns (the chunk's token blocks gathered into [S, G, PL], the
learning rates as a float32 tensor, the tables copied in and out). Here a
stand-in for the CUDA capture runs that same body on those buffers at
every replay, so the buffer bookkeeping, the cache and the launch counts
are held on the CPU against the step loop as it was before the graphs
(`*_loop` below: the walk blocks sliced from the corpus, the learning rate
a Python float), bit for bit: over several chunks, one of them wrapping
around the corpus' blocks; through a fit cut and resumed from a
checkpoint; and through two fits that share cached graphs. SDNE's three
trainers and `dense_fit` (tied and untied), whose steps take their
gradients by autograd or in closed form and run Adam on the graph's
buffers, are held the same way against a plain loop of steps on the
module and its `Adam` (`sdne_loop`, `dense_loop`). The capture on the
card itself is held against the loop in `tests/test_torch_card.py`.
"""

import numpy as np
import pytest
import torch

from graphembedding_tpu_torch.models import line as tline
from graphembedding_tpu_torch.ops.rows import gather_rows
from graphembedding_tpu_torch.train import chunk_graph as cg
from graphembedding_tpu_torch.train import hsoftmax as ths
from graphembedding_tpu_torch.train import skipgram as tsg
from graphembedding_tpu_torch.utils.metrics import MetricsLogger


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's CPU training (several test
    processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class StandInCapture:
    """The CUDA capture's stand-in: `capture` runs the warm-up, then the
    body once, and keeps the body and its outputs; each replay runs the
    body again on the same buffers and writes its results into those
    outputs, as a replayed graph overwrites its own."""

    def __init__(self, device):
        self.body = self.outputs = None

    def capture(self, body, warm_up):
        warm_up()
        self.body, self.outputs = body, body()
        return self.outputs

    def replay(self):
        for o, new in zip(self.outputs, self.body()):
            o.copy_(new)

    def release(self):
        self.body = self.outputs = None


@pytest.fixture
def graphs(monkeypatch):
    """The CPU takes the graph path through `StandInCapture`; the cache is
    emptied before and after. Yields the list of stand-ins made."""
    made = []

    def capture(device):
        made.append(StandInCapture(device))
        return made[-1]

    cg.release()
    monkeypatch.setitem(cg.CAPTURES, "cpu", capture)
    yield made
    cg.release()


def without_graphs():
    """Back to the CPU's loop: the cache emptied, the stand-in gone."""
    cg.release()
    del cg.CAPTURES["cpu"]


# ---- the step loops as they were before the chunk graphs --------------

def sgns_loop(w_cat, walks, eff, negs, alpha, min_alpha, t0, total_steps,
              *, block_walks, window, negative, neg_share_packs=1,
              update_cap=8.0):
    NW, L = walks.shape
    geo = tsg.block_geometry(NW, L, block_walks, neg_share_packs)
    S, K = eff.shape[0], negs.shape[2]
    window_ok, dm = tsg.window_geometry(L, geo.PL, window, walks.device)
    lrs = tsg.step_lrs(t0, S, alpha, min_alpha, total_steps)
    neg_w = float(np.float32(negative) / np.float32(K))
    losses, pairs = [], []
    for s in range(S):
        off = (t0 + s) % geo.n_blocks * geo.Bw
        tok = walks[off: off + geo.Bw].reshape(geo.G, geo.PL)
        loss, p = tsg.sgns_step(
            w_cat, tok, eff[s], negs[s], float(lrs[s]), window_ok=window_ok,
            dm=dm, nsp=geo.nsp, neg_w=neg_w, update_cap=float(update_cap))
        losses.append(loss)
        pairs.append(p)
    return w_cat, torch.stack(losses), torch.stack(pairs)


def hs_loop(w_in, w_tree, walks, points, codes, eff, alpha, min_alpha, t0,
            total_steps, *, block_walks, window, update_cap=8.0):
    NW, L = walks.shape
    geo = tsg.block_geometry(NW, L, block_walks, 1)
    S = eff.shape[0]
    window_ok, dm = tsg.window_geometry(L, geo.PL, window, walks.device)
    lrs = tsg.step_lrs(t0, S, alpha, min_alpha, total_steps)
    losses, pairs = [], []
    for s in range(S):
        off = (t0 + s) % geo.n_blocks * geo.Bw
        tok = walks[off: off + geo.Bw].reshape(geo.G, geo.PL)
        loss, p = ths.hs_step(w_in, w_tree, tok, eff[s], points, codes,
                              float(lrs[s]), window_ok=window_ok, dm=dm,
                              update_cap=float(update_cap))
        losses.append(loss)
        pairs.append(p)
    return w_in, w_tree, torch.stack(losses), torch.stack(pairs)


def line_loop(emb, ctx, hs, tposs, tnegs, lrs, *, negative, k_shared=0,
              update_cap=8.0):
    losses = [tline.line_step(emb, ctx, hs[s], tposs[s], tnegs[s], lrs[s],
                              negative=negative, k_shared=k_shared,
                              update_cap=update_cap)
              for s in range(hs.shape[0])]
    return emb, ctx, torch.stack(losses)


# ---- chunk bodies on static buffers against the loops -----------------

V, L, NW = 40, 6, 150
# 150 walks of 6: P = 21 walks a group, blocks of 21 walks (one group, the
# block clamped to whole groups): 7 blocks, chunks of S = 3 steps, so the
# third chunk (t0 = 6) takes blocks 6, 0, 1
S, BLOCK_WALKS, CHUNK_T0 = 3, 21, (0, 3, 6)


def corpus(seed=0):
    """NW walks of L over V nodes; one walk in ten stops early (-1 pads)."""
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, V, (NW, L)).astype(np.int32)
    stop = np.where(rng.random(NW) < 0.1, rng.integers(1, L, NW), L)
    walks[np.arange(L)[None, :] >= stop[:, None]] = -1
    return torch.from_numpy(walks)


def test_chunks_wrap_around_the_blocks():
    geo = tsg.block_geometry(NW, L, BLOCK_WALKS, 1)
    assert geo.n_blocks == 7 and geo.n_blocks % S
    assert [(t0 + s) % geo.n_blocks for t0 in CHUNK_T0
            for s in range(S)][-S:] == [6, 0, 1]
    blocks = tsg.chunk_blocks(corpus(), 6, S, geo)
    walks = corpus()
    for s, b in enumerate((6, 0, 1)):
        assert torch.equal(blocks[s], walks[b * geo.Bw:(b + 1) * geo.Bw]
                           .reshape(geo.G, geo.PL))


@pytest.mark.parametrize("path", ["loop", "graph"])
@pytest.mark.parametrize("block_walks,nsp,S_,t0s,cap", [
    (BLOCK_WALKS, 1, S, CHUNK_T0, 8.0),
    (BLOCK_WALKS, 1, S, CHUNK_T0, 1.5),
    # two groups sharing negatives: 3 blocks of 42 walks, chunks of 2 steps,
    # the second takes blocks 2 and 0
    (42, 2, 2, (0, 2, 4), 8.0)])
def test_sgns_chunks_equal_the_loop(graphs, path, block_walks, nsp, S_, t0s,
                                    cap):
    """Three chunks of `sgns_block_chunk_cat` (launched one by one, or
    through the graph path's buffers) torch.equal to the loop."""
    if path == "loop":
        without_graphs()
    walks = corpus(1)
    geo = tsg.block_geometry(NW, L, block_walks, nsp)
    assert geo.nsp == nsp and geo.n_blocks % S_
    gen = torch.Generator().manual_seed(2)
    w0 = torch.cat([(torch.rand((V, 8), generator=gen) - 0.5) / 8,
                    torch.randn((V, 8), generator=gen) * 0.1], 1)
    kw = dict(block_walks=block_walks, window=2, negative=5,
              neg_share_packs=nsp, update_cap=cap)
    got, want = w0.clone(), w0.clone()
    for t0 in t0s:
        eff = tsg.window_draws(gen, (S_, geo.G, geo.PL), 2)
        negs = torch.randint(0, V, (S_, geo.G2, 4), generator=gen,
                             dtype=torch.int32)
        _, lg, pg = tsg.sgns_block_chunk_cat(
            got, walks, eff, negs, 0.025, 1e-4, t0, 9.0, **kw)
        _, lw, pw = sgns_loop(want, walks, eff, negs, 0.025, 1e-4, t0, 9.0,
                              **kw)
        assert torch.equal(lg, lw) and torch.equal(pg, pw)
        assert torch.equal(got, want)
    assert not torch.equal(got, w0)
    assert len(graphs) == (path == "graph")  # one capture, three replays


@pytest.mark.parametrize("path", ["loop", "graph"])
def test_hs_chunks_equal_the_loop(graphs, path):
    if path == "loop":
        without_graphs()
    walks = corpus(3)
    geo = tsg.block_geometry(NW, L, BLOCK_WALKS, 1)
    counts = tsg.corpus_counts(walks, V)
    points, codes, _ = ths.build_huffman(counts)
    points, codes = torch.from_numpy(points), torch.from_numpy(codes)
    gen = torch.Generator().manual_seed(4)
    w_in0 = (torch.rand((V, 8), generator=gen) - 0.5) / 8
    w_tree0 = torch.randn((V - 1, 8), generator=gen) * 0.1
    got = [w_in0.clone(), w_tree0.clone()]
    want = [w_in0.clone(), w_tree0.clone()]
    kw = dict(block_walks=BLOCK_WALKS, window=2, update_cap=2.0)
    for t0 in CHUNK_T0:
        eff = tsg.window_draws(gen, (S, geo.G, geo.PL), 2)
        *_, lg, pg = ths.hs_block_chunk(*got, walks, points, codes, eff,
                                        0.025, 1e-4, t0, 9.0, **kw)
        *_, lw, pw = hs_loop(*want, walks, points, codes, eff, 0.025, 1e-4,
                             t0, 9.0, **kw)
        assert torch.equal(lg, lw) and torch.equal(pg, pw)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert len(graphs) == (path == "graph")


@pytest.mark.parametrize("path", ["loop", "graph"])
@pytest.mark.parametrize("order,k_shared", [("first", 0), ("second", 0),
                                            ("second", 10)])
def test_line_chunks_equal_the_loop(graphs, path, order, k_shared):
    if path == "loop":
        without_graphs()
    gen = torch.Generator().manual_seed(5)
    D, B, K = 8, 16, 5
    emb0 = torch.randn((V, D), generator=gen) * 0.1
    ctx0 = None if order == "first" else torch.randn((V, D),
                                                     generator=gen) * 0.1
    got = [emb0.clone(), None if ctx0 is None else ctx0.clone()]
    want = [emb0.clone(), None if ctx0 is None else ctx0.clone()]
    src = torch.randint(0, V, (60,), generator=gen, dtype=torch.int32)
    dst = torch.randint(0, V, (60,), generator=gen, dtype=torch.int32)
    neg_table = torch.randint(0, V, (256,), generator=gen,
                              dtype=torch.int32)
    accept = torch.rand((60,), generator=gen)
    alias = torch.randint(0, 60, (60,), generator=gen)
    for t0 in (0, 4):
        hs, tposs, tnegs, lrs = tline.line_bulk_samples(
            src, dst, accept, alias, neg_table, gen, 0.025, t0, 8.0,
            chunk_steps=4, batch_size=B, negative=K, k_shared=k_shared)
        kw = dict(negative=K, k_shared=k_shared)
        *_, lg = tline.line_steps(*got, hs, tposs, tnegs, lrs, **kw)
        *_, lw = line_loop(*want, hs, tposs, tnegs, lrs, **kw)
        assert torch.equal(lg, lw)
        assert torch.equal(got[0], want[0])
        assert ctx0 is None or torch.equal(got[1], want[1])
    assert len(graphs) == (path == "graph")


def test_step_takes_the_learning_rate_as_a_tensor():
    """sgns_step and hs_step give the same bits with lr a float and a 0-d
    float32 tensor of its value."""
    walks = corpus(6)
    geo = tsg.block_geometry(NW, L, BLOCK_WALKS, 1)
    window_ok, dm = tsg.window_geometry(L, geo.PL, 2, walks.device)
    tok = walks[:geo.Bw].reshape(geo.G, geo.PL)
    gen = torch.Generator().manual_seed(7)
    eff = tsg.window_draws(gen, (geo.G, geo.PL), 2)
    lr = tsg.step_lrs(3, 1, 0.025, 1e-4, 7.0)[0]
    w = torch.randn((V, 16), generator=gen) * 0.1
    neg = torch.randint(0, V, (geo.G2, 4), generator=gen, dtype=torch.int32)
    out = []
    for lr_ in (float(lr), torch.tensor(lr)):
        w_ = w.clone()
        loss, p = tsg.sgns_step(w_, tok, eff, neg, lr_, window_ok=window_ok,
                                dm=dm, nsp=1, neg_w=1.25, update_cap=2.0)
        out.append((w_, loss, p))
    assert all(torch.equal(a, b) for a, b in zip(*out))
    points, codes, _ = ths.build_huffman(tsg.corpus_counts(walks, V))
    points, codes = torch.from_numpy(points), torch.from_numpy(codes)
    out = []
    for lr_ in (float(lr), torch.tensor(lr)):
        w_in, w_tree = w[:, :8].clone(), w[:V - 1, 8:].clone()
        loss, p = ths.hs_step(w_in, w_tree, tok, eff, points, codes, lr_,
                              window_ok=window_ok, dm=dm, update_cap=2.0)
        out.append((w_in, w_tree, loss, p))
    assert all(torch.equal(a, b) for a, b in zip(*out))


# ---- fits through the cache ---------------------------------------------

class Interrupt(Exception):
    pass


class StopAt(MetricsLogger):
    """Raises on its n-th line, after the trainer logged that chunk and
    before it saved it."""

    def __init__(self, n):
        super().__init__(quiet=True)
        self.n, self.lines = n, 0

    def log(self, **fields):
        super().log(**fields)
        self.lines += 1
        if self.lines == self.n:
            raise Interrupt


SGNS_KW = dict(embed_size=8, window=2, epochs=3, block_walks=21,
               k_shared=8, chunk_steps=3)
HS_KW = dict(embed_size=8, window=2, epochs=3, block_walks=21,
             chunk_steps=3)


def fit(kind, walks, **kw):
    if kind == "sgns":
        w_cat, losses = tsg.SkipGramTrainer(tsg.SkipGramConfig(
            **SGNS_KW)).fit(walks, V, **kw)
        return (w_cat,), losses
    w_in, w_tree, losses = ths.HSTrainer(**HS_KW).fit(walks, V, **kw)
    return (w_in, w_tree), losses


@pytest.mark.parametrize("kind", ["sgns", "hs"])
def test_resumed_fit_through_graphs_equals_uninterrupted(graphs, tmp_path,
                                                        kind):
    """A fit cut mid-epoch and resumed from its checkpoint (a new table
    tensor, restored from the file) replays the cached graph into the new
    table, and ends where an uninterrupted fit and the loop end."""
    walks = corpus(8)
    tables, losses = fit(kind, walks)
    # 7 blocks an epoch, 3 chunks of 3 steps; cut in the second epoch's
    # second chunk, resumed from the checkpoint of its first (step 12)
    with pytest.raises(Interrupt):
        fit(kind, walks, checkpoint_dir=str(tmp_path), checkpoint_every=1,
            metrics=StopAt(5))
    resumed, rest = fit(kind, walks, checkpoint_dir=str(tmp_path),
                        checkpoint_every=1)
    assert len(graphs) == 1  # one capture for all three fits
    assert losses.shape[0] == 27 and rest.shape[0] == 27 - 4 * S
    assert torch.equal(rest, losses[4 * S:])
    assert all(torch.equal(a, b) for a, b in zip(resumed, tables))
    without_graphs()
    loop_tables, loop_losses = fit(kind, walks)
    assert torch.equal(loop_losses, losses)
    assert all(torch.equal(a, b) for a, b in zip(loop_tables, tables))


def test_line_resumed_through_graphs_equals_uninterrupted(graphs, tmp_path,
                                                          monkeypatch):
    from graphembedding_tpu_torch import LINE
    from graphembedding_tpu_torch.data import datasets as tds

    ds = tds.synthetic_wiki(num_nodes=60, num_classes=3, seed=0)
    # two chunks an order
    kw = dict(batch_size=16, epochs=int(np.ceil(1.5 * tline.CHUNK_STEPS * 16
                                                / ds.graph.num_edges)))
    want = LINE(ds.graph, embedding_size=8, order="all",
                device="cpu").train(**kw)
    chunk, calls = tline.line_train_chunk, []

    def interrupted(*a, **k):
        calls.append(1)
        if len(calls) == 3:  # order 'second''s first chunk
            raise Interrupt
        return chunk(*a, **k)

    monkeypatch.setattr(tline, "line_train_chunk", interrupted)
    with pytest.raises(Interrupt):
        LINE(ds.graph, embedding_size=8, order="all", device="cpu").train(
            checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    monkeypatch.setattr(tline, "line_train_chunk", chunk)
    got = LINE(ds.graph, embedding_size=8, order="all", device="cpu").train(
        checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    assert len(graphs) == 2  # order 'first' (no context table), 'second'
    assert torch.equal(got.embedding_table, want.embedding_table)
    assert torch.equal(got.context_emb, want.context_emb)


@pytest.mark.parametrize("kind", ["sgns", "hs"])
def test_two_fits_through_the_cache_equal_fresh_fits(graphs, kind):
    """Two fits (other corpora, other seeds) through one cached graph equal
    the same fits each with a graph captured afresh, and the loop's."""
    a, b = corpus(9), corpus(10)
    cached = [fit(kind, a, seed=1), fit(kind, b, seed=2)]
    assert len(graphs) == 1 and len(cg.held("cpu")) == 1
    fresh = []
    for walks, seed in ((a, 1), (b, 2)):
        cg.release()
        fresh.append(fit(kind, walks, seed=seed))
    assert len(graphs) == 3
    without_graphs()
    loop = [fit(kind, a, seed=1), fit(kind, b, seed=2)]
    for (tc, lc), (tf, lf), (tl, ll) in zip(cached, fresh, loop):
        assert torch.equal(lc, lf) and torch.equal(lc, ll)
        assert all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(tc, tf, tl))


# ---- launch counts --------------------------------------------------------

class Counter:
    """A stand-in for a kernel's wrapper and its launch count."""

    def __init__(self):
        self.launches = 0


def test_launch_counts_add_the_captured_launches_once_a_replay():
    k1, k2 = Counter(), Counter()
    k1.launches = 5
    counts = cg.LaunchCounts((k1, k2))
    with counts.capturing():
        k1.launches += 2  # a step's launches while it is captured
        k2.launches += 6
    assert (k1.launches, k2.launches) == (5, 0)  # a capture launches none
    assert counts.per_replay == (2, 6)
    for _ in range(3):
        counts.replayed()
    assert (k1.launches, k2.launches) == (11, 18)
    with pytest.raises(Interrupt):
        with counts.capturing():  # a failed capture leaves no count
            k2.launches += 1
            raise Interrupt
    assert (k1.launches, k2.launches) == (11, 18)


def launching_step(b, s, ops):
    """A step that, through the kernels (ops "kernels"; the plain versions
    are None), counts two gathers (on the card it would launch them), and
    adds s + 1 to its table."""
    if ops == "kernels":
        gather_rows.launches += 2
    b["table"].add_(b["x"][s] + 1.0)
    return (b["table"].sum(),)


def test_chunk_graph_counts_its_launches_per_replay(graphs):
    before = gather_rows.launches
    table, x = torch.zeros(3), torch.arange(4.0)
    for chunk in range(3):
        out, = cg.run_chunk(launching_step, 4, {"table": table}, {"x": x},
                            ops="kernels", plain=None)
        assert gather_rows.launches == before + 8 * (chunk + 1)
    assert len(graphs) == 1  # captured once, replayed three times
    # the warm-up and the capture ran on the graph's own table; the
    # caller's table got the three replays alone, 1 + 2 + 3 + 4 each
    assert torch.equal(table, torch.full((3,), 30.0))
    assert torch.equal(out, 3 * torch.tensor([21.0, 23.0, 26.0, 30.0]))


def failing_step(b, s, ops):
    if ops == "kernels":
        gather_rows.launches += 1
    b["table"].add_(1.0)
    if s == 2:
        raise Interrupt  # a launch that fails inside the capture
    return (b["table"].sum(),)


def test_failed_capture_raises_and_leaves_nothing_behind(graphs):
    before = gather_rows.launches
    table = torch.zeros(3)
    with pytest.raises(Interrupt):
        cg.run_chunk(failing_step, 4, {"table": table}, {}, ops="kernels",
                     plain=None)
    assert torch.equal(table, torch.zeros(3))  # no loop ran on it
    assert gather_rows.launches == before
    assert not cg.held()


# ---- SDNE and the dense trainer: Adam steps as one graph ---------------

def sdne_graph():
    from graphembedding_tpu_torch.data import datasets as tds

    return tds.synthetic_wiki(num_nodes=50, num_classes=3, avg_degree=4,
                              seed=3).graph


SDNE_MODES = {  # (train, steps an epoch)
    "full": (lambda m, **k: m.train(batch_size=100, epochs=7, **k), 1),
    "minibatch": (lambda m, **k: m.train(batch_size=16, epochs=7, **k), 4),
    "sparse": (lambda m, **k: m.train_sparse(epochs=7, row_chunk=20, **k),
               1),
}


def sdne_loop(m, mode, epochs=7):
    """The SDNE trainers as a plain loop of steps on the module: the loss
    by the module, the gradients by `torch.autograd.grad`, then
    `Adam.step`; the minibatch permutations drawn an epoch at a time, as
    the trainer draws them. Returns the losses."""
    from graphembedding_tpu_torch.models import sdne as tsdne

    opt = m._adam(1e-3)
    names, params = zip(*m.net.named_parameters())
    consts = (m.alpha, m.beta, m.nu1, m.nu2)
    gen = torch.Generator().manual_seed(m.seed + 2)
    losses = []
    with tsdne.f32_matmul():
        for _ in range(epochs):
            if mode == "minibatch":
                batches = tsdne.epoch_batches(
                    torch.randperm(m.graph.num_nodes, generator=gen), 16)
            else:
                batches = [None]
            for idx in batches:
                if mode == "full":
                    loss, _ = tsdne.sdne_loss(m.net, m.A, m.L, *consts)
                elif mode == "minibatch":
                    loss, _ = tsdne.sdne_loss(m.net, m.A[idx],
                                              m.L[idx][:, idx], *consts)
                else:
                    loss, _ = tsdne.sparse_sdne_loss(
                        m.net, m.sparse_inputs(), *consts, row_chunk=20)
                opt.step(dict(zip(names, torch.autograd.grad(loss,
                                                             params))))
                losses.append(loss.detach())
    return torch.stack(losses)


def sdne_params(m):
    return [p.detach().clone() for p in m.net.parameters()]


@pytest.mark.parametrize("path", ["loop", "graph"])
@pytest.mark.parametrize("mode", list(SDNE_MODES))
def test_sdne_chunks_equal_the_loop(graphs, tmp_path, path, mode):
    """Each SDNE trainer, in chunks of 3 epochs (a checkpoint each: 3, 3
    and 1 epochs) and in one chunk, launched one by one or through the
    graph path's buffers, torch.equal to the plain loop of steps."""
    from graphembedding_tpu_torch import SDNE

    if path == "loop":
        without_graphs()
    g = sdne_graph()
    train, per_epoch = SDNE_MODES[mode]
    ref = SDNE(g, hidden_size=[12, 6], device="cpu")
    want = sdne_loop(ref, mode)
    for kw in ({"checkpoint_dir": str(tmp_path), "checkpoint_every": 3},
               {}):
        m = SDNE(g, hidden_size=[12, 6], device="cpu")
        train(m, **kw)
        assert m.losses.shape == (7 * per_epoch,)
        assert torch.equal(m.losses, want)
        assert all(torch.equal(a, b)
                   for a, b in zip(sdne_params(m), sdne_params(ref)))
    # chunks of 3 and 1 epochs, then all 7 in one
    assert len(graphs) == (3 if path == "graph" else 0)


@pytest.mark.parametrize("mode", list(SDNE_MODES))
def test_sdne_resumed_through_graphs_equals_uninterrupted(graphs, tmp_path,
                                                          mode,
                                                          monkeypatch):
    """A train cut in its second chunk of 3 epochs and resumed from its
    checkpoint in a fresh model (new parameter tensors, a new Adam)
    replays the cached graphs into them, and ends where the uninterrupted
    train ends; the resumed train's losses are the last 4 epochs'."""
    from graphembedding_tpu_torch import SDNE
    from graphembedding_tpu_torch.models import sdne as tsdne

    g = sdne_graph()
    train, per_epoch = SDNE_MODES[mode]
    want = SDNE(g, hidden_size=[12, 6], device="cpu")
    train(want, checkpoint_dir=str(tmp_path / "full"), checkpoint_every=3)
    chunk, calls = tsdne.adam_chunk, []

    def interrupted(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise Interrupt
        return chunk(*a, **k)

    monkeypatch.setattr(tsdne, "adam_chunk", interrupted)
    with pytest.raises(Interrupt):
        train(SDNE(g, hidden_size=[12, 6], device="cpu"),
              checkpoint_dir=str(tmp_path / "cut"), checkpoint_every=3)
    monkeypatch.setattr(tsdne, "adam_chunk", chunk)
    m = SDNE(g, hidden_size=[12, 6], device="cpu")
    train(m, checkpoint_dir=str(tmp_path / "cut"), checkpoint_every=3)
    assert len(graphs) == 2  # chunks of 3 epochs and of 1
    assert torch.equal(m.losses, want.losses[3 * per_epoch:])
    assert all(torch.equal(a, b)
               for a, b in zip(sdne_params(m), sdne_params(want)))


@pytest.mark.parametrize("mode", list(SDNE_MODES))
def test_two_sdne_trains_through_the_cache_equal_fresh_trains(graphs, mode):
    """Two trains (other seeds) through one cached graph equal the same
    trains each with a graph captured afresh, and the loop's."""
    from graphembedding_tpu_torch import SDNE

    g = sdne_graph()
    train, _ = SDNE_MODES[mode]

    def run(seed):
        m = SDNE(g, hidden_size=[12, 6], seed=seed, device="cpu")
        train(m)
        return sdne_params(m), m.losses

    cached = [run(1), run(2)]
    assert len(graphs) == 1 and len(cg.held("cpu")) == 1
    fresh = []
    for seed in (1, 2):
        cg.release()
        fresh.append(run(seed))
    assert len(graphs) == 3
    without_graphs()
    loop = [run(1), run(2)]
    for (pc, lc), (pf, lf), (pl, ll) in zip(cached, fresh, loop):
        assert torch.equal(lc, lf) and torch.equal(lc, ll)
        assert all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(pc, pf, pl))
    assert not torch.equal(cached[0][1], cached[1][1])


def dense_loop(C, U0, tied, steps=6):
    """dense_fit as a plain loop of steps: the closed-form gradient, then
    `adam_update` with each step's bias corrections. Returns (U, W)."""
    from graphembedding_tpu_torch.train.adam import (
        AdamConfig, adam_update, bias_corrections)

    f32 = np.float32
    adam = AdamConfig(*(float(f32(x)) for x in (0.1, 0.9, 0.99, 1e-8)))
    occ = C.sum(1)
    counts = C.sum(1) + C.sum(0)
    q = counts.clamp(min=0.0).pow(0.75)
    q = q / q.sum().clamp(min=1e-12)
    occ_n, q_row = (5.0 * occ)[:, None], q[None, :]
    scale = 1.0 / C.sum().clamp(min=1.0)
    U, W = U0.clone(), torch.zeros_like(U0)
    mU, vU, mW, vW = (torch.zeros_like(U0) for _ in range(4))
    bc1, bc2 = bias_corrections(adam.b1, adam.b2, 0, steps, "cpu")
    for t in range(steps):
        S = torch.sigmoid(U @ (U.T if tied else W.T))
        G = (C * (S - 1.0) + occ_n * q_row * S) * scale
        if tied:
            adam_update([U], [(G + G.T) @ U], [mU], [vU], bc1[t], bc2[t],
                        adam)
        else:
            adam_update([U, W], [G @ W, G.T @ U], [mU, mW], [vU, vW],
                        bc1[t], bc2[t], adam)
    return U, W


def dense_inputs(seed):
    from graphembedding_tpu_torch.train import dense

    return dense.cooccurrence(corpus(seed), V, 2), dense.initial_table(V, 8, seed,
                                                                "cpu")


@pytest.mark.parametrize("path", ["loop", "graph"])
@pytest.mark.parametrize("tied", [False, True])
def test_dense_fit_equals_the_loop(graphs, path, tied):
    """dense_fit (one chunk of all its steps), launched one by one or
    through the graph path's buffers, torch.equal to the plain loop of
    steps; two fits (other corpora) through the cached graph equal the
    same fits with a graph captured afresh."""
    from graphembedding_tpu_torch.train import dense

    if path == "loop":
        without_graphs()

    def fit(seed):
        C, U0 = dense_inputs(seed)
        U, W, loss = dense.dense_fit(C, U0, 5, 0.75, 0.1, 0.9, 0.99, 1e-8,
                                     steps=6, tied=tied)
        assert torch.equal(U0, dense_inputs(seed)[1])  # U0 not written
        return U, W, loss

    cached = [fit(11), fit(12)]
    for (U, W, loss), seed in zip(cached, (11, 12)):
        want_U, want_W = dense_loop(*dense_inputs(seed), tied)
        assert torch.equal(U, want_U) and torch.equal(W, want_W)
        assert bool(torch.isfinite(loss).all()) and not torch.equal(
            U, dense_inputs(seed)[1])
        assert not tied or not W.any()
    assert len(graphs) == (path == "graph")
    if path == "graph":
        cg.release()
        fresh = fit(12)
        assert len(graphs) == 2
        assert all(torch.equal(a, b) for a, b in zip(fresh, cached[1]))


# ---- the sparse cap's chunks ------------------------------------------------

def test_sparse_sgns_chunks_through_graph_equal_the_loop(graphs):
    """Three chunks of `sgns_block_chunk_cat(sparse_cap=True)` through the
    graph path's buffers torch.equal to the same chunks launched one by
    one; the form is part of the cache key (a dense chunk of the same
    shapes captures a graph of its own)."""
    walks = corpus(3)
    geo = tsg.block_geometry(NW, L, BLOCK_WALKS, 1)
    gen = torch.Generator().manual_seed(4)
    w0 = torch.cat([(torch.rand((V, 8), generator=gen) - 0.5) / 8,
                    torch.randn((V, 8), generator=gen) * 0.1], 1)
    kw = dict(block_walks=BLOCK_WALKS, window=2, negative=5,
              neg_share_packs=1, update_cap=1.5)
    draws = [(tsg.window_draws(gen, (S, geo.G, geo.PL), 2),
              torch.randint(0, V, (S, geo.G2, 4), generator=gen,
                            dtype=torch.int32)) for _ in CHUNK_T0]

    def run(sparse):
        w = w0.clone()
        out = [tsg.sgns_block_chunk_cat(w, walks, eff, negs, 0.025, 1e-4,
                                        t0, 9.0, sparse_cap=sparse, **kw)[1:]
               for t0, (eff, negs) in zip(CHUNK_T0, draws)]
        return w, out

    got, got_out = run(True)
    assert len(graphs) == 1
    dense, _ = run(False)
    assert len(graphs) == 2 and len(cg.held("cpu")) == 2
    without_graphs()
    want, want_out = run(True)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for x, y in zip(got_out, want_out)
               for a, b in zip(x, y))
    assert not torch.equal(got, w0) and not torch.equal(got, dense)


# ---- the cache's bound ------------------------------------------------------

def sdne_trains(sizes):
    """SDNE full-batch trains on graphs of `sizes` nodes, one model after
    another (each deleted after its train), each leaving a graph of its
    own shape in the cache; yields (the model's parameters, the graphs
    held on the CPU and their bytes after the train)."""
    from graphembedding_tpu_torch import SDNE
    from graphembedding_tpu_torch.data import datasets as tds

    for n in sizes:
        g = tds.synthetic_wiki(num_nodes=n, num_classes=3, avg_degree=4,
                               seed=3).graph
        m = SDNE(g, hidden_size=[12, 6], seed=1, device="cpu")
        m.train(batch_size=n, epochs=3)
        params = sdne_params(m)
        del m
        yield params, len(cg.held("cpu")), cg.held_bytes("cpu")


PROBE = (200, 300, 400)


def test_cache_holds_every_shape_within_the_default_budget(graphs):
    """At the default budget the probe's three graphs stay held, their
    bytes the buffers each owns (the dense A and L among them)."""
    held = [(n, b) for _, n, b in sdne_trains(PROBE)]
    assert [n for n, _ in held] == [1, 2, 3]
    costs = [g.nbytes for g in cg.held("cpu")]
    assert all(c == cg.tensor_bytes(g.bufs.values())
               for c, g in zip(costs, cg.held("cpu")))
    assert costs[0] < costs[1] < costs[2]
    assert held[-1][1] == sum(costs) <= cg.BUDGET_BYTES


def test_cache_evicts_the_least_recent_past_its_budget(graphs, monkeypatch):
    """A budget that holds the last two of the probe's graphs: the third
    train's capture drops the first, the least recent; held() stays within
    the budget in count and in bytes after every train, and the trains
    equal those of an unbounded cache."""
    unbounded = [p for p, _, _ in sdne_trains(PROBE)]
    costs = [g.nbytes for g in cg.held("cpu")]
    cg.release()
    budget = costs[1] + costs[2]
    monkeypatch.setattr(cg, "BUDGET_BYTES", budget)
    before = len(graphs)
    counts = []
    for (params, n, nbytes), want in zip(sdne_trains(PROBE), unbounded):
        counts.append(n)
        assert nbytes <= budget
        assert all(torch.equal(a, b) for a, b in zip(params, want))
    assert counts == [1, 2, 2]
    assert len(graphs) - before == 3
    assert [g.nbytes for g in cg.held("cpu")] == costs[1:]
    assert graphs[before].body is None  # released
    assert all(g.body is not None for g in graphs[before + 1:])


def test_a_graph_over_the_budget_is_kept_alone_and_reused(graphs,
                                                          monkeypatch):
    """With a budget below any graph's cost each new shape's graph is held
    alone; two same-shape trains back to back capture once."""
    monkeypatch.setattr(cg, "BUDGET_BYTES", 1)
    got = [n for _, n, _ in sdne_trains((200, 200, 300, 300, 200))]
    assert got == [1] * 5
    assert len(graphs) == 3  # 200, 300, then 200 again after its eviction


def table_step(b, s, ops):
    b["t"].add_(b["x"][s])
    return (b["t"].sum(),)


def test_a_replay_makes_a_graph_the_most_recent(graphs, monkeypatch):
    """Graphs of n = 3, then 4, then 3 replayed, then 5 under a budget
    that holds the graphs of 3 and 5: the graph of 4, the least recently
    replayed, goes; release(device) drops those of the device."""
    tables = {n: torch.zeros(n) for n in (3, 4, 5)}

    def run(n):
        cg.run_chunk(table_step, 2, {"t": tables[n]},
                     {"x": torch.ones(2, n)}, ops="kernels", plain=None)

    run(3)
    run(4)
    # a graph of n owns t [n] and x [2, n] in float32: 12 n bytes
    assert cg.held_bytes("cpu") == 12 * (3 + 4)
    monkeypatch.setattr(cg, "BUDGET_BYTES", 12 * (3 + 5))
    run(3)  # a replay: no capture, 3 becomes the most recent
    assert len(graphs) == 2
    run(5)
    assert [g.bufs["t"].numel() for g in cg.held("cpu")] == [3, 5]
    assert cg.held_bytes("cpu") <= cg.BUDGET_BYTES
    assert torch.equal(tables[3], torch.full((3,), 4.0))
    cg.release("meta")  # no graph there: nothing dropped
    assert len(cg.held()) == 2
    cg.release("cpu")
    assert not cg.held() and cg.held_bytes() == 0


def test_group_release_under_the_budget(graphs, tmp_path, monkeypatch):
    """Over one gloo rank on CPU tensors (the graph path): graphs of two
    groups and of none; a tight budget evicts across groups by recency
    alone; release(group=) drops only that group's graphs, and
    `destroy_distributed` those of every group, keeping the graph of no
    group."""
    import torch.distributed as dist

    from graphembedding_tpu_torch.parallel import mesh as pmesh

    pmesh.init_distributed(0, 1, "gloo", f"file://{tmp_path}/store")
    try:
        g1, g2 = dist.new_group([0]), dist.new_group([0])

        def run(n, groups):
            cg.run_chunk(table_step, 2, {"t": torch.zeros(n)},
                         {"x": torch.ones(2, n)}, ops="kernels", plain=None,
                         groups=groups)

        run(3, (g1,))
        run(3, (g2,))
        run(4, ())
        run(5, (g1,))
        assert len(graphs) == 4 and len(cg.held("cpu", g1)) == 2
        cg.release(group=g1)
        assert [g.groups for g in cg.held()] == [(g2,), ()]
        # room for the graphs of 4 and 6 (12 n bytes each)
        monkeypatch.setattr(cg, "BUDGET_BYTES", 12 * (4 + 6))
        run(6, (g1,))  # over the budget: the oldest, g2's, goes
        assert [g.groups for g in cg.held()] == [(), (g1,)]
        assert len(graphs) == 5
        pmesh.destroy_distributed()
        assert [g.groups for g in cg.held()] == [()]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
