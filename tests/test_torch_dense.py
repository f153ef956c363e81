"""The port's dense expected-SGNS trainer against graphembedding_tpu's.

The co-occurrence matrix is compared allclose (rtol 1e-6: the port sums
w_d * N_d over distances, the JAX package one f32 value a pair) and against
a brute-force count. Five Adam steps of `dense_fit` from the JAX package's
own U0, tied and untied, hold rtol 1e-4, atol 2e-5 against `_dense_fit`
(float32 on both sides, products and sums in another order; W starts at 0,
so its first step is lr * sign(grad) and carries the gradient's rounding at
0.1 scale). LINE's dense adjacency and q are equal. The quality gates are
the ones of tests/test_dense.py, run on the port's own walks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu.train import dense as jdense
from graphembedding_tpu_torch import LINE, DeepWalk
from graphembedding_tpu_torch.data import datasets as tds
from graphembedding_tpu_torch.eval.classify import Classifier
from graphembedding_tpu_torch.models import line as tline
from graphembedding_tpu_torch.ops.walk import simulate_walks
from graphembedding_tpu_torch.train import dense as tdense


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's CPU training (several test
    processes run at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def microf1(ds, embeddings):
    return Classifier(embeddings).split_train_evaluate(
        ds.X, ds.Y, 0.8, seed=0)["micro"]


def random_walks(V=60, NW=300, L=10, seed=0):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, V, (NW, L)).astype(np.int32)
    walks[::7, 6:] = -1  # dead-ended walks
    walks[::11, 1:] = -1
    return walks


def test_cooccurrence_matches_bruteforce():
    """The port's copy of tests/test_dense.py's brute-force count: pads
    excluded, distance d weighing (W-d+1)/W each way."""
    walks = np.array([[0, 1, 2, -1], [2, 2, 0, 1]], np.int32)
    V, W = 3, 2
    C = tdense.cooccurrence(torch.from_numpy(walks), V, W).numpy()
    expect = np.zeros((V, V))
    for row in walks:
        toks = row[row >= 0]
        for i in range(len(toks)):
            for j in range(len(toks)):
                d = abs(i - j)
                if 1 <= d <= W:
                    expect[toks[i], toks[j]] += (W - d + 1) / W
    np.testing.assert_allclose(C, expect, rtol=1e-6)


@pytest.mark.parametrize("window,L", [(5, 10), (3, 10), (12, 10), (1, 2)])
def test_cooccurrence_matches_jax(window, L):
    walks = random_walks(L=L)
    want = np.asarray(jdense.cooccurrence(jnp.asarray(walks), num_nodes=60,
                                          window=window))
    got = tdense.cooccurrence(torch.from_numpy(walks), 60, window)
    assert got.dtype == torch.float32 and tuple(got.shape) == (60, 60)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def jax_u0(key, V, D):
    return np.asarray((jax.random.uniform(key, (V, D)) - 0.5) / D)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("with_q", [False, True])
def test_five_dense_fit_steps_match_jax(tied, with_q):
    """Five steps from the JAX package's U0 and C, with the corpus's own q
    or a given one (LINE's), against `_dense_fit(steps=5)`."""
    V, D = 60, 16
    C = tdense.cooccurrence(torch.from_numpy(random_walks()), V, 5)
    q = (torch.arange(V, dtype=torch.float32) % 7 + 1.0).pow(0.75) \
        if with_q else None
    key = jax.random.PRNGKey(1)
    f32 = jnp.float32
    ju, jw, jl = jdense._dense_fit(
        jnp.asarray(C.numpy()), key, f32(5), f32(0.75), f32(0.1), f32(0.9),
        f32(0.99), f32(1e-8), num_nodes=V, embed_size=D, steps=5,
        q=None if q is None else jnp.asarray(q.numpy()), tied=tied)
    u, w, loss = tdense.dense_fit(C, torch.tensor(jax_u0(key, V, D)), 5,
                                  0.75, 0.1, 0.9, 0.99, 1e-8, steps=5, q=q,
                                  tied=tied)
    assert tuple(loss.shape) == (1,)
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4,
                               atol=2e-5)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=1e-5)
    if tied:
        assert not w.any()


def test_initial_table_is_the_jax_formula_from_a_cpu_generator():
    u = tdense.initial_table(50, 8, 3, "cpu")
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(u, (torch.rand((50, 8), generator=gen) - 0.5) / 8)
    assert float(u.abs().max()) <= 0.5 / 8
    assert not torch.equal(u, tdense.initial_table(50, 8, 4, "cpu"))


def test_line_dense_inputs_match_jax():
    """LINE's dense adjacency (duplicate weights summed) and q = wdeg^0.75
    against the JAX package's `_train_dense` formulas."""
    g = tds.synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                           seed=5).graph
    src, dst, w = g.edges()
    # a duplicate of the first three edges, with their own weights
    g = type(g)(np.concatenate([src, src[:3]]), np.concatenate([dst, dst[:3]]),
                np.concatenate([w, np.float32([0.5, 1.5, 2.0])]),
                num_nodes=120)
    src, dst, w = g.edges()
    V = g.num_nodes
    jA = jnp.zeros((V * V,), jnp.float32).at[
        jnp.asarray(src * V + dst)].add(jnp.asarray(w)).reshape(V, V)
    jq = jnp.power(jnp.maximum(jA.sum(axis=1), 0.0), 0.75)
    A, q = tline.dense_line_inputs(g, "cpu")
    np.testing.assert_array_equal(A.numpy(), np.asarray(jA))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-6)


def test_dense_trainer_guards():
    """The port's copy of tests/test_dense.py's guards, plus the 46,340
    limit and the options the dense path refuses."""
    with pytest.raises(ValueError):
        tdense.DenseSGNSTrainer(max_nodes=64).fit(
            np.zeros((4, 5), np.int32), 100)
    with pytest.raises(ValueError, match="46340"):
        tdense.DenseSGNSTrainer(max_nodes=1 << 20).fit(
            np.zeros((4, 5), np.int32), 46341)
    ds = tds.synthetic_wiki(num_nodes=30, num_classes=2, avg_degree=4,
                            seed=1)
    m = DeepWalk(ds.graph, walk_length=4, num_walks=2, device="cpu")
    with pytest.raises(ValueError):
        m.train(trainer="dense", hs=1)
    for kw in ({"mesh": object()}, {"checkpoint_dir": "ckpt"},
               {"metrics": object()}):
        with pytest.raises(ValueError):
            m.train(trainer="dense", **kw)
    with pytest.raises(ValueError):
        m.train(trainer="nope")
    line = LINE(ds.graph, embedding_size=8, device="cpu")
    with pytest.raises(ValueError):
        line.train(trainer="nope")
    with pytest.raises(ValueError, match="V <= 16"):
        tdense.DenseSGNSTrainer(max_nodes=16).fit(m.walks, 30)


def test_walk_model_dense_is_the_trainer_on_its_walks():
    """train(trainer='dense') fits the model's own walks from seed + 1,
    with window, steps and lr passed through, and a second call gives the
    same tables."""
    ds = tds.synthetic_wiki(num_nodes=60, num_classes=3, seed=3)
    m = DeepWalk(ds.graph, walk_length=6, num_walks=4, seed=2,
                 device="cpu")
    m.train(embed_size=8, window_size=3, trainer="dense", steps=7, lr=0.05,
            negative=4, cap_mode="sparse")
    w_in, w_out = m.w_in.clone(), m.w_out.clone()
    u, w, losses = tdense.DenseSGNSTrainer(
        embed_size=8, window=3, negative=4, steps=7, lr=0.05).fit(
            m.walks, 60, seed=3)
    assert torch.equal(w_in, u) and torch.equal(w_out, w)
    assert torch.equal(m.losses, losses)
    assert m.trained_pairs == 0.0
    m.train(embed_size=8, window_size=3, trainer="dense", steps=7, lr=0.05,
            negative=4)
    assert torch.equal(m.w_in, w_in)
    assert len(m.get_embeddings()) == 60


def test_dense_trainer_community_gate():
    """tests/test_dense.py's community gate on the port (>= 0.9)."""
    ds = tds.synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                            seed=5)
    m = DeepWalk(ds.graph, walk_length=10, num_walks=20, seed=0,
                 device="cpu")
    m.train(embed_size=32, window_size=5, trainer="dense", steps=100)
    assert microf1(ds, m.get_embeddings()) >= 0.9


def test_dense_trainer_hard_sbm_gate():
    """tests/test_dense.py's near-threshold gate (>= 0.5) on the port's own
    corpus of 20 walks of 10 a node."""
    ds = tds.synthetic_wiki_hard()
    gen = torch.Generator().manual_seed(0)
    walks = simulate_walks(ds.graph, 20, 10, generator=gen)
    w_in, _, _ = tdense.DenseSGNSTrainer(embed_size=64, steps=150).fit(
        walks, ds.graph.num_nodes)
    emb = w_in.numpy()
    e = {ds.graph.vocab.idx2node[i]: emb[i]
         for i in range(ds.graph.num_nodes)}
    assert microf1(ds, e) >= 0.5


def test_line_dense_trainer():
    """tests/test_dense.py's LINE gate on the port: order 'all' in closed
    form (first order tied, second untied) >= 0.85."""
    ds = tds.synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                            seed=5)
    m = LINE(ds.graph, embedding_size=32, order="all", device="cpu")
    m.train(trainer="dense", steps=200)
    assert tuple(m.losses.shape) == (2,)
    assert torch.isfinite(m.losses).all() and m.sampled_edges == 0
    assert microf1(ds, m.get_embeddings()) >= 0.85


def test_struc2vec_dense_trainer_quality(tmp_path):
    """tests/test_dense.py's Struc2Vec gate on the port: the dense
    expected-SGNS objective on flight-brazil's multilayer walks, seed 3,
    >= 0.8."""
    from graphembedding_tpu_torch import Struc2Vec

    ds = tds.synthetic_flight()
    m = Struc2Vec(ds.graph, walk_length=10, num_walks=80,
                  temp_path=str(tmp_path) + "/", seed=3, device="cpu")
    m.train(hs=0, trainer="dense", steps=300)
    assert microf1(ds, m.get_embeddings()) >= 0.8
