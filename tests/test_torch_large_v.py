"""The large-V path of the port against the JAX package, on the CPU.

- The million-node generators (`benchmarks/million.py`) at V = 5,000: the
  edge count of the JAX package's exactly, a CSR without loops, symmetric,
  with sorted columns, and the same skew in distribution (the random
  streams differ): the mean degree of the lowest and highest 10% of ids
  within 6% of the JAX graph's, and for `clustered_graph` the share of
  edges within `spread` within 0.01.
- The sparse cap (`train/skipgram.py::sparse_capped_update`): one chunk of
  `sgns_block_chunk_cat(sparse_cap=True)` against the JAX package's from
  the same table and draws, on a corpus with pads beside a row-0 token,
  with a cap that binds and a negative weight that is not a power of two,
  within rtol 1e-4, atol 1e-6 (the tolerance of the dense chunk's parity
  test: float32 sums in another order); the port's sparse chunk against
  its dense one within the same; `cap_mode='auto'` against the JAX rule.
- `DeepWalk(..., device="cpu").train(cap_mode="sparse")` through the
  hard-SBM gate of `tests/test_torch_models.py`.
- The harness modules' `main` at a tiny size on the CPU: their JSON keys.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import million as jmillion
from graphembedding_tpu.train import skipgram as jsg
from graphembedding_tpu_torch.benchmarks import million
from graphembedding_tpu_torch.interop import tables_from_jax, tables_to_numpy
from graphembedding_tpu_torch.train import skipgram as tsg


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's CPU training (several test
    processes share the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---- the generators --------------------------------------------------------

V_GEN, DEG = 5000, 10
SKEW_RTOL = 0.06  # the 10% tails' mean degrees, port against JAX
SPREAD, SPREAD_ATOL = 64, 0.01


def csr_checks(g):
    """No loops, symmetric, columns sorted within each row."""
    src, dst, _ = g.edges()
    assert not (src == dst).any()
    V = g.num_nodes
    assert np.array_equal(np.sort(src * V + dst), np.sort(dst * V + src))
    # sorted in (source, target) order, which sorts each row's columns
    key = src * V + dst
    assert (np.diff(key) >= 0).all()


def tail_degrees(g):
    """Mean degree of the lowest and of the highest 10% of ids."""
    n = g.num_nodes // 10
    return g.degree[:n].mean(), g.degree[-n:].mean()


def within_spread(g, spread):
    """Share of directed entries whose endpoints lie within `spread` ids
    around the ring."""
    src, dst, _ = g.edges()
    gap = np.abs(src - dst)
    gap = np.minimum(gap, g.num_nodes - gap)
    return float((gap <= spread).mean())


@pytest.mark.parametrize("kind", ["synthetic_graph", "clustered_graph"])
def test_generators_match_jax(kind):
    kw = {"spread": SPREAD} if kind == "clustered_graph" else {}
    got = getattr(million, kind)(V_GEN, DEG, seed=0, device="cpu", **kw)
    want = getattr(jmillion, kind)(V_GEN, DEG, seed=0, **kw)
    n_rand = million.random_edge_count(V_GEN, DEG)
    assert n_rand == V_GEN * (DEG - 2) // 2
    assert got.num_nodes == want.num_nodes == V_GEN
    assert got.num_edges == want.num_edges == 2 * (V_GEN + n_rand)
    assert got.degree.mean() == want.degree.mean()
    csr_checks(got)
    assert got.row_ptr[-1] == got.num_edges
    assert np.array_equal(np.diff(got.row_ptr), got.degree)
    for a, b in zip(tail_degrees(got), tail_degrees(want)):
        assert abs(a - b) <= SKEW_RTOL * b, (tail_degrees(got),
                                             tail_degrees(want))
    low, high = tail_degrees(got)
    if kind == "synthetic_graph":
        assert low > 2 * high  # the skew toward low ids is there
        assert within_spread(got, SPREAD) < 0.5
    else:
        assert abs(within_spread(got, SPREAD)
                   - within_spread(want, SPREAD)) <= SPREAD_ATOL
        assert within_spread(got, SPREAD) > 0.9


def test_generators_are_seeded():
    a = million.synthetic_graph(2000, 6, seed=3, device="cpu")
    b = million.synthetic_graph(2000, 6, seed=3, device="cpu")
    c = million.synthetic_graph(2000, 6, seed=4, device="cpu")
    assert np.array_equal(a.col_idx, b.col_idx)
    assert not np.array_equal(a.col_idx, c.col_idx)


# ---- the sparse cap --------------------------------------------------------

RTOL, ATOL = 1e-4, 1e-6


def make_corpus(V, NW, L, seed):
    """Random walks with -1 tails on a fifth of the rows; node 0 at the
    start of the first walks, beside their pads."""
    rng = np.random.default_rng(seed)
    walks = rng.integers(1, V, (NW, L)).astype(np.int32)
    cut = rng.integers(2, L, NW)
    tails = (np.arange(L)[None, :] >= cut[:, None]) & (
        rng.random(NW) < 0.2)[:, None]
    walks[tails] = -1
    walks[:8, 0] = 0
    walks[:4, L // 2:] = -1
    return walks


def jax_draws(key, t0, S, G, PL, G2, K, W, neg_table):
    """The draws of the JAX chunk, recomputed outside its jit."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, t0))
    eff = W - (jax.random.uniform(k1, (S, G, PL)) * W).astype(
        jnp.int32).clip(0, W - 1)
    neg_idx = jax.random.randint(k2, (S, G2, K), 0, neg_table.shape[0],
                                 dtype=jnp.int32)
    return np.array(eff), np.array(neg_table[neg_idx])


# (V, K, cap): K = 8 gives neg_w = 5/8, K = 6 a weight that is not a
# power of two; with V = 40 and cap 2 most rows are capped
SPARSE_CASES = [(120, 8, 8.0), (40, 6, 2.0)]


def chunk_case(V, K, cap, seed=7):
    D, L, NW, Bw, W, S, t0 = 16, 10, 200, 48, 5, 4, 0
    walks = make_corpus(V, NW, L, seed)
    rng = np.random.default_rng(seed + 1)
    w_in = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    neg_table = jnp.asarray(jsg.negative_table(
        jsg.corpus_counts(walks, V), 0.75, 1 << 12))
    key = jax.random.PRNGKey(seed + 2)
    geo = tsg.block_geometry(NW, L, Bw, 2)
    eff, negs = jax_draws(key, t0, S, geo.G, geo.PL, geo.G2, K, W,
                          neg_table)
    kw = dict(block_walks=Bw, window=W, negative=5, neg_share_packs=2,
              update_cap=cap)
    return dict(walks=walks, w_in=w_in, w_out=w_out, neg_table=neg_table,
                key=key, eff=eff, negs=negs, kw=kw, S=S, t0=t0, K=K)


def port_chunk(c, sparse):
    w_cat = tables_from_jax(c["w_in"], c["w_out"])
    got, loss, pairs = tsg.sgns_block_chunk_cat(
        w_cat, torch.from_numpy(c["walks"]), torch.from_numpy(c["eff"]),
        torch.from_numpy(c["negs"]), 0.025, 1e-4, c["t0"], 20.0,
        sparse_cap=sparse, **c["kw"])
    assert got is w_cat  # updated in place
    return tables_to_numpy(got), loss.numpy(), pairs.numpy()


@pytest.mark.parametrize("V,K,cap", SPARSE_CASES)
def test_sparse_chunk_matches_jax(V, K, cap):
    c = chunk_case(V, K, cap)
    want, want_loss, want_pairs = jsg.sgns_block_chunk_cat(
        jnp.concatenate([c["w_in"], c["w_out"]], 1),
        jnp.asarray(c["walks"]), c["neg_table"], c["key"],
        jnp.float32(0.025), jnp.float32(1e-4), jnp.int32(c["t0"]),
        jnp.float32(20.0), chunk_steps=c["S"], k_shared=K,
        neg_share_walks=8, sparse_cap=True, **c["kw"])
    (got_in, got_out), loss, pairs = port_chunk(c, sparse=True)
    want = np.asarray(want)
    D = got_in.shape[1]
    np.testing.assert_allclose(got_in, want[:, :D], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_out, want[:, D:], rtol=RTOL, atol=ATOL)
    # row 0 (a token beside the pads, which count into its occupancy)
    # moved, as every row the corpus touches
    assert np.abs(got_in[0] - c["w_in"][0]).max() > 1e-4
    assert np.abs(got_out - c["w_out"]).max() > 1e-3
    np.testing.assert_array_equal(pairs, np.asarray(want_pairs))
    np.testing.assert_allclose(loss, np.asarray(want_loss), rtol=RTOL)


@pytest.mark.parametrize("V,K,cap", SPARSE_CASES)
def test_sparse_chunk_matches_dense(V, K, cap):
    """The two forms compute the same update, in another order."""
    c = chunk_case(V, K, cap, seed=11)
    (s_in, s_out), s_loss, s_pairs = port_chunk(c, sparse=True)
    (d_in, d_out), d_loss, d_pairs = port_chunk(c, sparse=False)
    np.testing.assert_allclose(s_in, d_in, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(s_out, d_out, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(s_pairs, d_pairs)
    np.testing.assert_allclose(s_loss, d_loss, rtol=RTOL)
    assert not (np.array_equal(s_in, d_in) and np.array_equal(s_out, d_out))


def test_sparse_step_counts_pads_into_row_zero():
    """A pad counts into row 0's occupancy, as the JAX step scatters it
    there: with a cap of 1, row 0's update is its gradient over its tokens
    plus the pads, not over its tokens alone."""
    V, D = 6, 4
    tok = torch.tensor([[0, 1, 2, -1, -1, -1]], dtype=torch.int32)
    neg = torch.tensor([[3, 4]], dtype=torch.int32)
    g = torch.arange(1.0, 1 + 6 * D).view(1, 6, D)
    w = torch.zeros((V, 2 * D))
    mask = torch.zeros((1, 6, 6))
    tsg.sparse_capped_update(w, tok, neg, g, g, torch.ones((1, 2, D)), mask,
                             1.0, 0.5, 1.0, tsg.PLAIN)
    # row 0: one token and three pads -> scale 1/4
    assert torch.equal(w[0], -torch.cat([g[0, 0], g[0, 0]]) / 4)
    assert torch.equal(w[1], -torch.cat([g[0, 1], g[0, 1]]))
    assert torch.equal(w[3], torch.cat([torch.zeros(D), -torch.ones(D)]))
    assert torch.equal(w[5], torch.zeros(2 * D))


class ChunkArgs(Exception):
    """Raised by a stand-in of the JAX chunk with its keyword arguments."""


@pytest.mark.parametrize("V", [(1 << 16) - 1, 1 << 16])
def test_auto_rule_matches_jax(V, monkeypatch):
    """The form `cap_mode='auto'` picks at V: the JAX trainer's, read from
    the keyword its fit passes to its chunk."""

    def stop(*a, **kw):
        raise ChunkArgs(kw)

    monkeypatch.setattr(jsg, "sgns_block_chunk_cat", stop)
    walks = np.random.default_rng(0).integers(0, V, (64, 5)).astype(
        np.int32)
    cfg = jsg.SkipGramConfig(embed_size=2, epochs=1, neg_table_size=1 << 8)
    with pytest.raises(ChunkArgs) as got:
        jsg.SkipGramTrainer(cfg).fit(walks, V)
    want = got.value.args[0]["sparse_cap"]
    assert want == (V >= 1 << 16)
    assert tsg.sparse_cap_for("auto", V) == want
    assert tsg.sparse_cap_for("sparse", V) and not tsg.sparse_cap_for(
        "dense", V)
    assert tsg.SkipGramConfig().cap_mode == jsg.SkipGramConfig().cap_mode
    with pytest.raises(ValueError):
        tsg.sparse_cap_for("Sparse", V)


def test_fit_takes_the_form_of_its_cap_mode(monkeypatch):
    """SkipGramTrainer.fit passes the rule's form to every chunk."""
    seen = []
    chunk = tsg.sgns_block_chunk_cat

    def spy(*a, **kw):
        seen.append(kw["sparse_cap"])
        return chunk(*a, **kw)

    monkeypatch.setattr(tsg, "sgns_block_chunk_cat", spy)
    walks = torch.from_numpy(make_corpus(50, 40, 6, seed=3))
    for mode, want in (("sparse", True), ("dense", False), ("auto", False)):
        seen.clear()
        w_cat, losses = tsg.SkipGramTrainer(
            embed_size=8, epochs=1, chunk_steps=2, cap_mode=mode).fit(
                walks, 50, seed=1)
        assert seen and set(seen) == {want}
        assert torch.isfinite(w_cat).all() and torch.isfinite(losses).all()


def test_deepwalk_sparse_cap_hard_sbm_gate():
    """tests/test_torch_models.py::test_deepwalk_hard_sbm_gate with the
    sparse cap: every seed >= 0.55, mean >= 0.60."""
    from graphembedding_tpu_torch import DeepWalk
    from graphembedding_tpu_torch.data import datasets as tds
    from graphembedding_tpu_torch.eval.classify import Classifier

    ds = tds.synthetic_wiki_hard()
    scores = []
    for seed in (0, 1, 2):
        m = DeepWalk(ds.graph, walk_length=10, num_walks=20, seed=seed,
                     device="cpu")
        m.train(embed_size=64, window_size=5, iter=3, cap_mode="sparse")
        r = Classifier(m.get_embeddings()).split_train_evaluate(
            ds.X, ds.Y, 0.8, seed=0)
        scores.append(r["micro"])
    assert min(scores) >= 0.55, scores
    assert sum(scores) / len(scores) >= 0.60, scores


# ---- the harness modules at a tiny size --------------------------------

def test_million_main_keys(capsys):
    rows = million.main(["--nodes", "1000", "--num-walks", "1",
                         "--device", "cpu"])
    assert [r["bench"] for r in rows] == ["million_build", "million_walks",
                                          "million_train"]
    build, walks, train = rows
    assert set(build) == {"bench", "nodes", "edges", "seconds", "card"}
    assert build["edges"] == 2 * (1000 + 4000)
    assert set(walks) == {"bench", "nodes", "walkers", "walked_edges_per_s",
                          "seconds_warm", "seconds_cold", "card"}
    assert walks["walkers"] == 1000
    assert set(train) == {"bench", "nodes", "epochs", "cap_mode",
                          "seconds_warm", "seconds_cold", "pairs_per_s",
                          "mean_loss_tail", "device_ms", "busy_share",
                          "reserved_mib", "card"}
    assert train["cap_mode"] == "dense" and train["pairs_per_s"] > 0
    assert np.isfinite(train["mean_loss_tail"])
    assert len(capsys.readouterr().out.splitlines()) == 3


def test_table_scale_main_keys():
    from graphembedding_tpu_torch.benchmarks import table_scale

    rows = table_scale.main(["--nodes", "800", "--walks-per-node", "1",
                             "--reps", "1", "--device", "cpu"])
    assert [r["cap_mode"] for r in rows] == ["dense", "sparse"]
    for r in rows:
        assert set(r) == {"bench", "nodes", "cap_mode", "pairs_per_s",
                          "chunk_ms", "held_graphs", "held_mib", "card"}
        assert r["nodes"] == 800 and r["pairs_per_s"] > 0


def test_pq_crossover_main_keys(tmp_path):
    from graphembedding_tpu_torch.benchmarks import pq_crossover

    out = tmp_path / "rows.jsonl"
    rows = pq_crossover.main(["--nodes", "3000", "--degrees", "8", "32",
                              "--reps", "1", "--device", "cpu",
                              "--out", str(out)])
    assert [r["max_degree"] for r in rows] == [8, 32]
    for r in rows:
        assert set(r) == {
            "max_degree", "dpad", "nodes", "p", "q", "exact_s",
            "rejection_s", "exact_edges_per_s", "rejection_edges_per_s",
            "rejection_dense_s", "rejection_dense_edges_per_s", "winner",
            "nbr_matrix_mb", "select_pq_kernel", "card"}
        assert r["winner"] in ("exact", "rejection", "rejection_dense")
        assert r["select_pq_kernel"] == "exact"
    assert len(out.read_text().splitlines()) == 2
    g = pq_crossover.regular_graph(100, 4)
    assert g.num_edges == 400 and (g.degree == 4).all()
