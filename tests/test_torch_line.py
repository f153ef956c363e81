"""Port's LINE against graphembedding_tpu/models/line.py.

Fixed by their inputs, so compared exactly or allclose: the edge list, the
alias tables, the degree^0.75 negative table (a stated count of boundary
slots differs), and eight steps on the JAX package's own draws
(rtol=1e-5, atol=1e-6: the dots and the einsums sum in another order than
XLA's). Sampling is compared in distribution: the port draws from
`torch.Generator`s. Quality: the hard-SBM gate of tests/test_models.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu.data import datasets as jds
from graphembedding_tpu.models import line as jline
from graphembedding_tpu.ops import alias as jalias
from graphembedding_tpu.train.skipgram import inverse_cdf_table as j_icdf
from graphembedding_tpu_torch import LINE
from graphembedding_tpu_torch.data import datasets as tds
from graphembedding_tpu_torch.eval.classify import Classifier
from graphembedding_tpu_torch.interop import line_tables_from_jax
from graphembedding_tpu_torch.models import line as tline
from graphembedding_tpu_torch.ops import alias as talias
from graphembedding_tpu_torch.train.skipgram import (
    inverse_cdf_table as t_icdf,
)


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's CPU training: with a thread per
    core in each of several test processes at once, the hard-SBM gates
    ran some 30x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def small_graph():
    return tds.synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                              p_in=0.85, seed=3)


def test_graph_edges_equal_jax():
    a = small_graph().graph.edges()
    b = jds.synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                           p_in=0.85, seed=3).graph.edges()
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("probs", [
    np.array([1.0, 2.0, 3.0, 0.5]),
    np.array([0.0, 0.0, 5.0]),
    np.zeros(4),  # degenerate: uniform
    np.array([]),
    np.random.default_rng(0).random(500) ** 3,
])
def test_alias_tables_bit_equal(probs):
    for got, want in zip(talias.build_alias_table(probs),
                         jalias.build_alias_table(probs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if probs.size:
        norm = probs / probs.sum() if probs.sum() > 0 else probs
        assert talias.create_alias_table(norm) == \
            jalias.create_alias_table(norm)
        acc, al = talias.build_alias_table(probs)
        np.testing.assert_array_equal(
            talias.alias_sample_host(acc, al, np.random.default_rng(1), 64),
            jalias.alias_sample_host(acc, al, np.random.default_rng(1), 64))
        np.random.seed(2)
        a = [talias.alias_sample(acc, al) for _ in range(20)]
        np.random.seed(2)
        assert a == [jalias.alias_sample(acc, al) for _ in range(20)]


def test_line_negative_table_vs_jax():
    """The LINE negative table on the Wiki-scale graph. Both build it in
    f32, but XLA's sum and cumsum run in another order, so a CDF boundary
    can round to the next slot: 127 of the 2^20 slots differ here. Each
    such slot holds the id of a neighbouring slot of the JAX table."""
    g = tds.synthetic_wiki().graph
    m = LINE(g, embedding_size=4, device="cpu")
    src, _, w = g.edges()
    wdeg = np.zeros(g.num_nodes)
    np.add.at(wdeg, src, w.astype(np.float64))
    p = np.power(wdeg, 0.75).astype(np.float32)
    want = np.asarray(jax.jit(j_icdf, static_argnums=1)(jnp.asarray(p),
                                                         1 << 20))
    got = m._neg_table.numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    diff = np.nonzero(got != want)[0]
    assert len(diff) <= 200, len(diff)  # 127 measured; < 0.02% of slots
    for j in diff:
        assert got[j] in (want[j - 1], want[j + 1]), j
    # a small table agrees everywhere
    q = np.random.default_rng(5).random(120).astype(np.float32)
    np.testing.assert_array_equal(
        t_icdf(torch.from_numpy(q), 1 << 12).numpy(),
        np.asarray(j_icdf(jnp.asarray(q), 1 << 12)))


def jax_case(order_first, k_shared, S=8, V=120, D=16, B=64, K=5, seed=0):
    """Tables, edge arrays and the draws of JAX `_line_bulk_samples`."""
    rng = np.random.default_rng(seed)
    ds = jds.synthetic_wiki(num_nodes=V, num_classes=3, avg_degree=8,
                            p_in=0.85, seed=3)
    jm = jline.LINE(ds.graph, embedding_size=D, seed=seed)
    draws = jline._line_bulk_samples(
        jm._edge_src, jm._edge_dst, jm._edge_accept, jm._edge_alias,
        jm._neg_table, jax.random.PRNGKey(seed + 7), jnp.float32(0.025),
        jnp.int32(3), jnp.float32(20.0), chunk_steps=S, batch_size=B,
        negative=K, k_shared=k_shared)
    # tables moved off their init scale, so the updates are not tiny
    jm.first_emb = jnp.asarray(
        (rng.standard_normal((V, D)) * 0.3).astype(np.float32))
    jm.second_emb = jnp.asarray(
        (rng.standard_normal((V, D)) * 0.3).astype(np.float32))
    jm.context_emb = jnp.asarray(
        (rng.standard_normal((V, D)) * 0.3).astype(np.float32))
    return jm, draws


@pytest.mark.parametrize("k_shared", [0, 20])
@pytest.mark.parametrize("order", ["first", "second"])
def test_line_steps_match_jax(order, k_shared):
    """Eight steps of JAX `_make_line_step` under `lax.scan` against the
    port's `line_steps`, on the same draws, from tables carried over by
    `line_tables_from_jax`."""
    B, K = 64, 5
    jm, draws = jax_case(order == "first", k_shared, B=B, K=K)
    first, second, context = line_tables_from_jax(
        jm.first_emb, jm.second_emb, jm.context_emb)
    step = jline._make_line_step(batch_size=B, negative=K,
                                 order_first=order == "first",
                                 k_shared=k_shared, update_cap=8.0)
    if order == "first":
        carry = (jm.first_emb, jnp.zeros((1, jm.embedding_size)))
        emb, ctx = first, None
    else:
        carry = (jm.second_emb, jm.context_emb)
        emb, ctx = second, context.clone()
    (want_emb, want_ctx), want_loss = jax.lax.scan(step, carry, draws)
    t = [torch.from_numpy(np.array(x)) for x in draws]
    if k_shared:
        assert tuple(t[2].shape) == (8, B // (k_shared // K), k_shared)
    got_emb, got_ctx, loss = tline.line_steps(
        emb.clone(), ctx, *t, negative=K, k_shared=k_shared,
        ops=tline.KERNELS)
    np.testing.assert_allclose(got_emb.numpy(), np.asarray(want_emb),
                               rtol=1e-5, atol=1e-6)
    assert np.abs(got_emb.numpy() - emb.numpy()).max() > 1e-3  # it moved
    if order == "second":
        np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               rtol=1e-5, atol=1e-6)
    # the plain ops give the same steps
    p_emb, _, p_loss = tline.line_steps(
        emb.clone(), None if ctx is None else context.clone(), *t,
        negative=K, k_shared=k_shared, ops=tline.PLAIN)
    np.testing.assert_array_equal(p_emb.numpy(), got_emb.numpy())
    np.testing.assert_array_equal(p_loss.numpy(), loss.numpy())


def test_bulk_samples_distribution():
    """Edges are drawn by weight, negatives by weighted out-degree^0.75
    (atol 5e-4 on frequencies of about 0.004 and 0.017 from 614k and 3.1M
    draws: some 6 standard errors); the learning rates equal the JAX
    schedule to f32 rounding."""
    g = tds.synthetic_wiki(num_nodes=60, num_classes=3, avg_degree=4,
                           seed=1).graph
    m = LINE(g, embedding_size=4, device="cpu")
    gen = torch.Generator().manual_seed(0)
    S, B, K = 600, 1024, 5
    hs, tposs, tnegs, lrs = tline.line_bulk_samples(
        m._edge_src, m._edge_dst, m._edge_accept, m._edge_alias,
        m._neg_table, gen, 0.025, 100, 1000.0, chunk_steps=S,
        batch_size=B, negative=K, k_shared=0)
    assert hs.dtype == torch.int32 and tuple(tnegs.shape) == (S, B, K)
    src, dst, w = g.edges()
    pair = hs.numpy().astype(np.int64) * g.num_nodes + tposs.numpy()
    edge_id = {s * g.num_nodes + d: i for i, (s, d) in enumerate(zip(src,
                                                                      dst))}
    freq = np.bincount([edge_id[x] for x in pair.ravel()],
                       minlength=len(src)) / pair.size
    np.testing.assert_allclose(freq, w / w.sum(), atol=5e-4)
    wdeg = np.zeros(g.num_nodes)
    np.add.at(wdeg, src, w.astype(np.float64))
    q = wdeg ** 0.75
    nfreq = np.bincount(tnegs.numpy().ravel(), minlength=g.num_nodes)
    np.testing.assert_allclose(nfreq / nfreq.sum(), q / q.sum(), atol=5e-4)
    want = 0.025 * np.maximum(
        1.0 - (100 + np.arange(S, dtype=np.float32)) / np.float32(1000.0),
        1e-4)
    np.testing.assert_allclose(lrs.numpy(), want, rtol=1e-6)
    _, _, shared, _ = tline.line_bulk_samples(
        m._edge_src, m._edge_dst, m._edge_accept, m._edge_alias,
        m._neg_table, gen, 0.025, 0, 10.0, chunk_steps=2, batch_size=B,
        negative=K, k_shared=64)
    # NG = 64 // 5 = 12 pairs a set, lowered to 8 so that it divides B
    assert tline._neg_grouping(B, K, 64) == jline._neg_grouping(B, K, 64)
    assert tuple(shared.shape) == (2, B // 8, 64)


@pytest.mark.parametrize("order", ["first", "second", "all"])
def test_tables_from_jax_give_same_embeddings(order):
    ds = small_graph()
    jm = jline.LINE(jds.synthetic_wiki(num_nodes=120, num_classes=3,
                                       avg_degree=8, p_in=0.85,
                                       seed=3).graph,
                    embedding_size=8, order=order, seed=4)
    m = LINE(ds.graph, embedding_size=8, order=order, device="cpu")
    m.first_emb, m.second_emb, m.context_emb = line_tables_from_jax(
        jm.first_emb, jm.second_emb, jm.context_emb)
    got, want = m.get_embeddings(), jm.get_embeddings()
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_line_trains_each_order_on_cpu():
    g = small_graph().graph
    for order in ("first", "second", "all"):
        m = LINE(g, embedding_size=8, order=order, seed=1, k_shared=20,
                 device="cpu")
        ctx0 = m.context_emb.clone()
        m.train(batch_size=128, epochs=2)
        n_steps = round(2 * g.num_edges / 128)
        assert m.losses.shape == (512 * -(-n_steps // 512),)
        assert torch.isfinite(m.losses).all()
        assert m.sampled_edges == (2 if order == "all" else 1) * 512 * 128
        emb = m.get_embeddings()
        assert len(emb) == g.num_nodes
        assert next(iter(emb.values())).shape == (
            (16,) if order == "all" else (8,))
        if order == "first":  # no context table is touched
            assert torch.equal(m.context_emb, ctx0)


def test_scatter_gate(monkeypatch):
    """LINE scatters through the shared rule of `ops.rows`: K4 takes tables
    up to SMALL_V_ROWS rows, K2 the larger ones."""
    from graphembedding_tpu_torch.ops import rows

    assert tline.KERNELS.scatter_add is rows.scatter_add_table
    calls = []
    monkeypatch.setattr(rows, "scatter_add_small",
                        lambda *a: calls.append("K4"))
    monkeypatch.setattr(rows, "scatter_add_rows",
                        lambda *a: calls.append("K2"))
    ids = torch.zeros(1, dtype=torch.int32)
    for v in (2405, rows.SMALL_V_ROWS, rows.SMALL_V_ROWS + 1):
        rows.scatter_add_table(torch.empty((v, 8)), ids, torch.zeros(1, 8))
    assert calls == ["K4", "K4", "K2"]


def test_line_hard_sbm_gate():
    """The gate of tests/test_models.py::test_line_hard_sbm_gate on the
    port, with its seeds and bounds: every seed >= 0.52, mean >= 0.56."""
    ds = tds.synthetic_wiki_hard()
    scores = []
    for seed in (0, 1):
        m = LINE(ds.graph, embedding_size=64, order="second", seed=seed,
                 device="cpu")
        m.train(batch_size=1024, epochs=80)
        r = Classifier(m.get_embeddings()).split_train_evaluate(
            ds.X, ds.Y, 0.8, seed=0)
        scores.append(r["micro"])
    assert min(scores) >= 0.52, scores
    assert sum(scores) / len(scores) >= 0.56, scores


def test_line_unsupported_options_raise(tmp_path):
    m = LINE(small_graph().graph, embedding_size=4, device="cpu")
    for kw in ({"mesh": object()}, {"sync_every": 4}):
        with pytest.raises(NotImplementedError):
            m.train(epochs=1, **kw)
    # checkpoints are ported (tests/test_torch_checkpoint.py): one
    # subdirectory an order; checkpoint_every alone saves nothing
    m.train(epochs=1, checkpoint_every=2)
    m.train(epochs=1, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert os.listdir(tmp_path) == ["second"]
    # trainer='dense' trains (tests/test_torch_dense.py)
    m.train(trainer="dense", steps=2)
    assert m.losses.shape == (1,) and torch.isfinite(m.losses).all()
    with pytest.raises(ValueError):
        m.train(trainer="block")
    with pytest.raises(ValueError):
        LINE(small_graph().graph, order="third")
