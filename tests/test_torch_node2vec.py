"""Port's weighted and (p,q) walks and Node2Vec against the JAX package.

Tables and lookups fixed by their inputs (alias tables and draws, CSR
search, the sampler rule, the neighbor views) must be equal. The walks
draw from a torch.Generator, so they are held to the JAX package's
conditional laws (the oracle and tolerance of tests/test_walks.py) and to
a JAX corpus by chi-square tests, not to its values.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2_contingency
from test_walks import exact_pq_second_step_dist

from graphembedding_tpu.data import datasets as jds
from graphembedding_tpu.graph import Graph as JaxGraph
from graphembedding_tpu.models import Node2Vec as JaxNode2Vec
from graphembedding_tpu.ops import alias as jalias
from graphembedding_tpu.ops import walk as jwalk
from graphembedding_tpu_torch import Node2Vec
from graphembedding_tpu_torch.data import datasets as tds
from graphembedding_tpu_torch.eval.classify import Classifier
from graphembedding_tpu_torch.graph import Graph, row_weight_sums
from graphembedding_tpu_torch.ops import walk
from graphembedding_tpu_torch.ops.alias import alias_draw, build_row_alias


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's CPU training: with a thread per
    core in each of several test processes at once, the hard-SBM gates
    ran some 30x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def both_graphs(src, dst, w=None, **kw):
    src, dst = np.asarray(src), np.asarray(dst)
    return Graph(src, dst, w, **kw), JaxGraph(src, dst, w, **kw)


def random_graphs(seed, V=50, E=400, weights="random"):
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, V, E), rng.integers(0, V, E)
    w = (rng.integers(1, 4, E) * rng.random(E)).astype(np.float32)
    if weights == "wiki":  # integers in {1, 2, 3}: some rows all ones
        w = rng.integers(1, 4, E).astype(np.float32)
        w[src % 3 == 0] = 1.0
    return both_graphs(src, dst, w, num_nodes=V + 5)


def triangle_with_tail(w=None):
    return both_graphs([0, 1, 2, 2], [1, 2, 0, 3], w, directed=False)


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("seed,weights", [(0, "random"), (1, "random"),
                                          (2, "wiki")])
def test_build_row_alias_equals_jax(seed, weights):
    g, jg = random_graphs(seed, weights=weights)
    accept, alias = build_row_alias(g.row_ptr, g.edge_weight)
    want_a = np.ones_like(accept)
    want_l = np.zeros_like(alias)
    for v in range(g.num_nodes):
        s, e = g.row_ptr[v], g.row_ptr[v + 1]
        if e > s:
            want_a[s:e], want_l[s:e] = jalias.build_alias_table(
                g.edge_weight[s:e])
    np.testing.assert_array_equal(accept, want_a)
    np.testing.assert_array_equal(alias, want_l)
    # the JAX Graph may take its C++ builder
    ja, jl = jg.host_alias()
    np.testing.assert_allclose(accept, ja, rtol=1e-6)
    np.testing.assert_array_equal(alias, jl)
    assert g.host_alias() is g.host_alias()


def test_alias_draw_equals_jax():
    g, _ = random_graphs(2)
    accept, alias = build_row_alias(g.row_ptr, g.edge_weight)
    rng = np.random.default_rng(3)
    rows = rng.choice(np.flatnonzero(g.degree > 0), 4000)
    offs = g.row_ptr[rows].astype(np.int32)
    sizes = g.degree[rows]
    u1, u2 = rng.random((2, 4000), dtype=np.float32)
    # u1 just below 1 reaches the clamp to size - 1
    u1[:8] = np.float32(1.0) - np.float32(2.0 ** -24)
    got = alias_draw(*(torch.as_tensor(x) for x in (accept, alias, offs,
                                                     sizes, u1, u2)))
    want = jalias.alias_draw(*(jnp.asarray(x) for x in (accept, alias, offs,
                                                        sizes, u1, u2)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_row_weight_sums_per_row():
    g, _ = random_graphs(4)
    want = np.array([g.edge_weight[g.row_ptr[v]:g.row_ptr[v + 1]]
                     .astype(np.float64).sum() for v in range(g.num_nodes)])
    got = g.weight_sums("cpu").numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert (got[g.degree == 0] == 0).all() and (g.degree == 0).any()
    assert g.weight_sums("cpu") is g.weight_sums("cpu")


def test_wsum_exact_past_two_to_the_24_edges():
    """The port sums each row in float64; the JAX package's difference of
    a global f32 cumsum (ops/walk.py simulate_walks) loses rows whose
    boundaries past 2^24 fall on odd offsets."""
    n = (1 << 24) + 4096
    row_ptr = np.array([0, (1 << 24) - 3, (1 << 24) + 1, (1 << 24) + 1001,
                        (1 << 24) + 1001, (1 << 24) + 3001, n],
                       dtype=np.int64)
    w = np.ones(n, dtype=np.float32)
    want = np.diff(row_ptr).astype(np.float64)
    got = row_weight_sums(row_ptr, w)
    np.testing.assert_array_equal(got.astype(np.float64), want)
    csum = jnp.concatenate([jnp.zeros((1,), jnp.float32),
                            jnp.cumsum(jnp.asarray(w))])
    rp = jnp.asarray(row_ptr.astype(np.int32))
    jax_wsum = np.asarray(csum[rp[1:]] - csum[rp[:-1]])
    assert (jax_wsum.astype(np.float64) != want).any()


@pytest.mark.parametrize("seed", [0, 5])
def test_csr_find_equals_jax(seed):
    g, jg = random_graphs(seed)
    rng = np.random.default_rng(seed + 10)
    rows = rng.integers(0, g.num_nodes, 3000)
    vals = rng.integers(-1, g.num_nodes, 3000)
    dg = g.to("cpu")
    found, idx = walk.csr_find(dg.row_ptr, dg.col_idx, dg.degree,
                               torch.as_tensor(rows), torch.as_tensor(vals),
                               max_degree=g.max_degree)
    jd = jg.device
    jfound, jidx = jwalk.csr_find(jd.row_ptr, jd.col_idx, jd.degree,
                                  jnp.asarray(rows, jnp.int32),
                                  jnp.asarray(vals, jnp.int32),
                                  max_degree=jg.max_degree)
    found, jfound = found.numpy(), np.asarray(jfound)
    np.testing.assert_array_equal(found, jfound)
    np.testing.assert_array_equal(idx.numpy()[found], np.asarray(jidx)[found])
    oracle = np.array([v in set(g.neighbors(r).tolist())
                       for r, v in zip(rows, vals)])
    np.testing.assert_array_equal(found, oracle)


@pytest.mark.parametrize("seed", [0, 6])
def test_row_membership_matches_a_set_oracle(seed):
    """The exact sampler's membership: each candidate searched in prev's
    padded row."""
    g, _ = random_graphs(seed)
    nbr, _ = g.neighbor_matrix("cpu")
    rng = np.random.default_rng(seed + 20)
    prev = rng.integers(0, g.num_nodes, 500)
    cand = rng.integers(-1, g.num_nodes, (500, 12)).astype(np.int32)
    got = walk.rows_contain(walk.sorted_rows(nbr[torch.as_tensor(prev)]),
                            torch.as_tensor(cand)).numpy()
    want = np.array([[c in set(g.neighbors(p).tolist()) for c in row]
                     for p, row in zip(prev, cand)])
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


PQ_CASES = [(20000, 8, 0.25, 4.0), (20000, 300, 0.25, 4.0),
            (20000, 512, 0.25, 4.0), (20000, 2048, 0.25, 4.0),
            (20000, 128, 1.0, 1.0), (20000, 512, 1.0, 1.0),
            (5_000_000, 1100, 0.25, 4.0), (900_000, 1100, 0.25, 4.0)]
PQ_GRID = [(v, d, p, q) for v in (1, 2405, 1_000_000, 10_000_000)
           for d in (0, 1, 139, 256, 384, 385, 640, 1536, 4096)
           for p, q in ((0.25, 4.0), (1.0, 1.0))]


@pytest.mark.parametrize("case", [PQ_CASES, PQ_GRID],
                         ids=["test_walks_cases", "grid"])
def test_select_pq_kernel_equals_jax(case):
    for V, d, p, q in case:
        assert (walk.select_pq_kernel(V, d)
                == jwalk.select_pq_kernel(V, d, p, q)), (V, d, p, q)
    assert walk.select_pq_kernel(2405, 139) == "exact"


def test_neighbor_views_equal_jax():
    g, jg = random_graphs(7)
    nbr, nbr_w = g.neighbor_matrix("cpu")
    jm = jg.neighbor_matrix
    d = max(g.max_degree, 1)
    assert tuple(nbr.shape) == (g.num_nodes, d)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(jm.nbr)[:, :d])
    np.testing.assert_array_equal(nbr_w.numpy(),
                                  np.asarray(jm.nbr_w)[:, :d])
    np.testing.assert_array_equal(g.neighbor_ids("cpu").numpy(),
                                  np.asarray(jg.neighbor_ids)[:, :d])
    # built once a device; the ids are the matrix's own
    assert g.neighbor_matrix("cpu")[1] is nbr_w
    assert g.neighbor_ids("cpu") is nbr
    assert g.to("cpu") is g.to(torch.device("cpu"))


def test_rejection_budget():
    """The JAX package's analytic budget: the envelope form at the
    canonical bias in one round of 22; the ub form clamped to 64 tries."""
    assert walk.rejection_budget(0.25, 4.0, envelope=True) == (22, 22)
    assert walk.rejection_budget(0.25, 4.0, envelope=False) == (32, 64)
    assert walk.rejection_budget(1.0, 1.0, envelope=True) == (8, 8)
    assert walk.rejection_budget(1.0, 1.0, envelope=False) == (8, 8)


# ------------------------------------------------------------ conditional laws


def gen(seed):
    return torch.Generator().manual_seed(seed)


def check_third_step(walks, jg, p, q, mids=(1, 2)):
    for mid in mids:
        sel = walks[walks[:, 1] == mid]
        if len(sel) < 1000:
            continue
        nbrs, target = exact_pq_second_step_dist(jg, 0, mid, p, q)
        freq = np.bincount(sel[:, 2], minlength=jg.num_nodes)[nbrs]
        np.testing.assert_allclose(freq / freq.sum(), target, atol=0.03)


def test_weighted_walk_distribution():
    g, _ = both_graphs([0, 0], [1, 2], np.array([3.0, 1.0], np.float32),
                       num_nodes=3)
    dg = g.to("cpu")
    accept, alias = g.alias_tables("cpu")
    walks = walk.weighted_walks(dg.row_ptr, dg.col_idx, dg.degree, accept,
                                alias, torch.zeros(20000, dtype=torch.int64),
                                length=2, generator=gen(3)).numpy()
    freq = np.bincount(walks[:, 1], minlength=3) / walks.shape[0]
    np.testing.assert_allclose(freq[1], 0.75, atol=0.02)
    np.testing.assert_allclose(freq[2], 0.25, atol=0.02)


def test_weighted_walks_dead_end():
    g, _ = both_graphs([0, 1], [1, 2], np.array([2.0, 5.0], np.float32),
                       num_nodes=3)
    walks = walk.simulate_walks(g, 2, 5, generator=gen(1),
                                kind="weighted").numpy()
    np.testing.assert_array_equal(walks[0], [0, 1, 2, -1, -1])
    np.testing.assert_array_equal(walks[2], [2, -1, -1, -1, -1])


@pytest.mark.parametrize("p,q", [(0.25, 4.0), (4.0, 0.25), (1.0, 1.0)])
def test_node2vec_exact_distribution(p, q):
    g, jg = triangle_with_tail()
    dg = g.to("cpu")
    nbr, nbr_w = g.neighbor_matrix("cpu")
    walks = walk.node2vec_walks(dg.degree, nbr, nbr_w,
                                torch.zeros(40000, dtype=torch.int64),
                                p, q, length=3, generator=gen(4)).numpy()
    check_third_step(walks, jg, p, q)


def rejection(g, p, q, seed, n=40000, weighted=False, **kw):
    dg = g.to("cpu")
    accept, alias = g.alias_tables("cpu")
    if weighted:
        kw.update(edge_weight=dg.edge_weight, wsum=g.weight_sums("cpu"))
    return walk.node2vec_walks_rejection(
        dg.row_ptr, dg.col_idx, dg.degree, accept, alias,
        torch.zeros(n, dtype=torch.int64), p, q, length=3,
        max_degree=g.max_degree, generator=gen(seed), **kw).numpy()


@pytest.mark.parametrize("p,q", [(0.25, 4.0), (2.0, 0.5)])
def test_node2vec_rejection_matches_exact(p, q):
    g, jg = triangle_with_tail()
    check_third_step(rejection(g, p, q, 5), jg, p, q)


@pytest.mark.parametrize("p,q", [(4.0, 1.0), (0.25, 4.0)])
def test_node2vec_rejection_envelope_weighted(p, q):
    g, jg = triangle_with_tail(np.array([3.0, 1.0, 2.0, 0.5], np.float32))
    check_third_step(rejection(g, p, q, 7, n=60000, weighted=True), jg, p, q)


def test_node2vec_rejection_envelope_matches_ub_form():
    g, _ = triangle_with_tail()
    freqs = {}
    for env in (False, True):
        walks = rejection(g, 0.25, 4.0, 8, n=60000, envelope=env)
        sel = walks[walks[:, 1] == 1]
        f = np.bincount(sel[:, 2], minlength=g.num_nodes).astype(float)
        freqs[env] = f / f.sum()
    np.testing.assert_allclose(freqs[True], freqs[False], atol=0.03)


@pytest.mark.parametrize("uniform_rows", [False, True],
                         ids=["dense", "uniform_rows"])
@pytest.mark.parametrize("p,q", [(0.25, 4.0), (2.0, 0.5)])
def test_node2vec_rejection_dense_membership(p, q, uniform_rows):
    g, jg = triangle_with_tail()
    walks = rejection(g, p, q, 9 + uniform_rows, nbr=g.neighbor_ids("cpu"),
                      uniform_rows=uniform_rows)
    check_third_step(walks, jg, p, q)


@pytest.mark.parametrize("sampler", ["exact", "rejection_dense",
                                     "rejection"])
def test_node2vec_walks_dead_end(sampler):
    # directed 0 -> 1 -> 2 -> 3, nothing out of 3 (row_ptr[3] == E)
    g, _ = both_graphs([0, 1, 2], [1, 2, 3], num_nodes=4)
    walks = walk.simulate_walks(g, 1, 6, generator=gen(2), kind="node2vec",
                                p=0.25, q=4.0, sampler=sampler).numpy()
    np.testing.assert_array_equal(walks[0], [0, 1, 2, 3, -1, -1])
    np.testing.assert_array_equal(walks[3], [3, -1, -1, -1, -1, -1])


# ------------------------------------------------------------------ corpus


N2V_GRAPH = dict(num_nodes=30, num_classes=2, avg_degree=4, seed=3)


@pytest.fixture(scope="module")
def jax_corpus():
    ds = jds.synthetic_wiki(**N2V_GRAPH)
    return JaxNode2Vec(ds.graph, walk_length=10, num_walks=2000, p=0.25,
                       q=4, seed=0).walks


def state_counts(walks, V):
    """counts[(prev, cur)] -> next-node counts over every hop of walks."""
    walks = np.asarray(walks).astype(np.int64)
    a, b, c = walks[:, :-2].ravel(), walks[:, 1:-1].ravel(), \
        walks[:, 2:].ravel()
    ok = c >= 0
    key = (a[ok] * V + b[ok]) * V + c[ok]
    flat = np.bincount(key, minlength=V ** 3).reshape(V * V, V)
    return flat


@pytest.mark.parametrize("sampler", ["exact", "rejection_dense",
                                     "rejection"])
def test_corpus_matches_jax_node2vec(jax_corpus, sampler):
    """Every (prev, cur) state with 2000 samples on both sides: a two-sample
    chi-square test of the next-node counts, none rejecting at 1e-3 over
    the number of states."""
    ds = tds.synthetic_wiki(**N2V_GRAPH)
    V = ds.graph.num_nodes
    ours = walk.simulate_walks(ds.graph, 2000, 10, generator=gen(11),
                               kind="node2vec", p=0.25, q=4.0,
                               sampler=sampler)
    a, b = state_counts(ours.numpy(), V), state_counts(jax_corpus, V)
    states = np.flatnonzero((a.sum(1) >= 2000) & (b.sum(1) >= 2000))
    assert len(states) >= 20
    worst = 1.0
    for s in states:
        table = np.stack([a[s], b[s]])
        table = table[:, table.sum(0) > 0]
        if table.shape[1] < 2:
            continue
        worst = min(worst, chi2_contingency(table)[1])
    assert worst >= 1e-3 / len(states), (worst, len(states))


@pytest.mark.parametrize("kind,sampler", [
    ("weighted", None), ("node2vec", "exact"),
    ("node2vec", "rejection_dense"), ("node2vec", "rejection")])
def test_walks_bit_identical_from_one_seed(kind, sampler):
    g = tds.synthetic_wiki(**N2V_GRAPH).graph
    a, b = (walk.simulate_walks(g, 20, 10, generator=gen(5), kind=kind,
                                p=0.25, q=4.0, sampler=sampler)
            for _ in range(2))
    assert torch.equal(a, b)
    c = walk.simulate_walks(g, 20, 10, generator=gen(6), kind=kind,
                            p=0.25, q=4.0, sampler=sampler)
    assert not torch.equal(a, c)
    adj = set(zip(*(x.tolist() for x in g.edges()[:2])))
    for row in a.numpy():
        assert all((u, v) in adj for u, v in zip(row[:-1], row[1:])
                   if v >= 0)


# ------------------------------------------------------------------- model


def test_node2vec_hard_sbm_gate():
    """The gate of tests/test_models.py::test_node2vec_hard_sbm_gate on
    the port, over seeds 0-2: every seed >= 0.53, mean >= 0.58."""
    ds = tds.synthetic_wiki_hard()
    scores = []
    for seed in (0, 1, 2):
        m = Node2Vec(ds.graph, walk_length=10, num_walks=20, p=0.25, q=4,
                     seed=seed, device="cpu")
        assert m.sampler == "exact" and not m.use_rejection_sampling
        m.train(embed_size=64, window_size=5, iter=3)
        r = Classifier(m.get_embeddings()).split_train_evaluate(
            ds.X, ds.Y, 0.8, seed=0)
        scores.append(r["micro"])
    assert min(scores) >= 0.53, scores
    assert sum(scores) / len(scores) >= 0.58, scores


def test_node2vec_rejection_smoke():
    ds = tds.synthetic_wiki(num_nodes=120, num_classes=3, seed=3)
    m = Node2Vec(ds.graph, walk_length=8, num_walks=4, p=0.25, q=4,
                 use_rejection_sampling=True, device="cpu")
    assert m.use_rejection_sampling and m.sampler == "rejection_dense"
    m.train(embed_size=16, window_size=3, iter=1)
    emb = m.get_embeddings()
    assert len(emb) == 120
    assert all(np.isfinite(v).all() and v.shape == (16,)
               for v in emb.values())


def test_node2vec_sampler_choice_follows_jax():
    import networkx as nx

    g = nx.relabel_nodes(nx.path_graph(12), {i: str(i) for i in range(12)})
    for flag in (None, False, True):
        ours = Node2Vec(g, walk_length=4, num_walks=2, device="cpu",
                        use_rejection_sampling=flag)
        ref = JaxNode2Vec(g, walk_length=4, num_walks=2,
                          use_rejection_sampling=flag)
        assert ours.use_rejection_sampling == ref.use_rejection_sampling
        assert tuple(ours.walks.shape) == tuple(ref.walks.shape)
