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
checkpoint; and through two fits that share cached graphs. The capture on
the card itself is held against the loop in `tests/test_torch_card.py`.
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
