"""The port's distributed-walk host code against graphembedding_tpu's.

Exact equality, array for array, on the same inputs: the partitioners
(`partition_csr` with alias edge arrays, `partition_neighbor_matrix`,
`partition_layers`), `locality_order`, `relabel_graph`, `_group_starts`,
and the collective-free routing math, `bucket_by_dest` (both methods, the
bcap and send_cap backpressure cases and the fuzz of
tests/test_walks_a2a.py) and `place_arrivals` (with and without the extra
column). Also `Graph.from_csr`, `free_device` and `out_weights`, and
`select_pq_kernel`'s memory budget.

The port's neighbor rows are max_degree wide; the JAX package pads them to
a multiple of 128 lanes (a TPU tiling rule), so its extra columns are
checked to hold pads only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu import graph as jgraph
from graphembedding_tpu.data import datasets as jds
from graphembedding_tpu.ops import walk as jwalk
from graphembedding_tpu.parallel import walks as jw
from graphembedding_tpu_torch import graph as tgraph
from graphembedding_tpu_torch.ops import walk as twalk
from graphembedding_tpu_torch.parallel import walks as tw


def _edges_zipf(V=64, seed=0):
    """tests/test_walks_a2a.py's hub graph: a ring plus geometric fans."""
    rng = np.random.default_rng(seed)
    edges = {(i, (i + 1) % V) for i in range(V)}
    for hub, fan in enumerate([V // 2, V // 4, V // 8, V // 16]):
        for t in rng.choice(V, fan, replace=False):
            t = int(t)
            if t != hub:
                edges.add((min(hub, t), max(hub, t)))
    src, dst = map(np.asarray, zip(*sorted(edges)))
    return src, dst, None


def _edges_star():
    k = 6
    return (np.zeros(k, dtype=int), np.arange(1, k + 1),
            np.arange(1, k + 1, dtype=np.float32))


def _edges_wiki():
    g = jds.synthetic_wiki(num_nodes=200, num_classes=4, avg_degree=6,
                           seed=3).graph
    src, dst, w = g.edges()
    return src, dst, w


GRAPHS = {"zipf": (_edges_zipf, False), "star": (_edges_star, False),
          "wiki": (_edges_wiki, True)}


def both_graphs(name):
    """(JAX Graph, port Graph) of the same edges."""
    make, directed = GRAPHS[name]
    src, dst, w = make()
    return (jgraph.Graph(src, dst, w, directed=directed),
            tgraph.Graph(src, dst, w, directed=directed))


def assert_parts_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_partition_csr_equals_jax(name, n):
    jg, tg = both_graphs(name)
    assert_parts_equal(tw.partition_csr(tg, n), jw.partition_csr(jg, n))
    ja, jl = jg.host_alias()
    ta, tl = tg.host_alias()
    arrays = lambda a, l: {"accept": (a.astype(np.float32), 1.0),  # noqa
                           "alias": (l.astype(np.int32), 0)}
    assert_parts_equal(tw.partition_csr(tg, n, edge_arrays=arrays(ta, tl)),
                       jw.partition_csr(jg, n, edge_arrays=arrays(ja, jl)))


@pytest.mark.parametrize("n", [1, 2, 3])
def test_partition_neighbor_matrix_equals_jax(n):
    for name in sorted(GRAPHS):
        jg, tg = both_graphs(name)
        got = tw.partition_neighbor_matrix(tg, n)
        want = jw.partition_neighbor_matrix(jg, n)
        d = got[4]
        assert d == max(tg.max_degree, 1) and got[3] == want[3]
        for g, w, pad in zip(got[:2], want[:2], (-1, 0.0)):
            np.testing.assert_array_equal(g, w[..., :d])
            assert (w[..., d:] == pad).all()
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(got[2], want[2])


@pytest.fixture(scope="module")
def layers():
    from graphembedding_tpu.models.struc2vec import (
        build_context_graph,
        build_layer_csr,
    )

    g = jgraph.Graph(*_edges_zipf(V=48, seed=1)[:2], directed=False)
    layer_edges, _ = build_context_graph(g)
    return build_layer_csr(layer_edges, g.num_nodes), g.num_nodes


@pytest.mark.parametrize("n", [1, 2, 5])
def test_partition_layers_equals_jax(layers, n):
    ly, V = layers
    assert_parts_equal(tw.partition_layers(ly, V, n),
                       jw.partition_layers(ly, V, n))
    # torch tensors in, as the models hold them
    assert_parts_equal(
        tw.partition_layers({k: torch.as_tensor(np.asarray(v))
                             for k, v in ly.items()}, V, n),
        jw.partition_layers(ly, V, n))


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_locality_order_and_relabel_equal_jax(name):
    jg, tg = both_graphs(name)
    perm = tw.locality_order(tg)
    np.testing.assert_array_equal(perm, jw.locality_order(jg))
    assert perm.dtype == np.int64
    got, want = tw.relabel_graph(tg, perm), jw.relabel_graph(jg, perm)
    for k in ("row_ptr", "col_idx", "edge_weight", "degree"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.num_nodes, got.num_edges) == (want.num_nodes,
                                               want.num_edges)


@pytest.mark.parametrize("V,num_walks,n", [(10, 3, 4), (200, 20, 2),
                                           (7, 1, 8), (2405, 80, 2)])
def test_group_starts_equals_jax(V, num_walks, n):
    vp = -(-V // n)
    got, want = tw._group_starts(V, num_walks, n, vp), \
        jw._group_starts(V, num_walks, n, vp)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[0].dtype == want[0].dtype


# ---- bucket_by_dest and place_arrivals --------------------------------


def buckets_both(v, w, t, vp, n, bcap, **kw):
    """(port, JAX) bucket_by_dest outputs as numpy."""
    got = tw.bucket_by_dest(*(torch.as_tensor(np.asarray(a, np.int32))
                              for a in (v, w, t)), vp, n, bcap, **kw)
    want = jw.bucket_by_dest(*(jnp.asarray(np.asarray(a, np.int32))
                               for a in (v, w, t)), vp, n, bcap, **kw)
    got = tuple(x.numpy() for x in got)
    want = tuple(np.asarray(x) for x in want)
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g, wt)
    return got


@pytest.mark.parametrize("method", ["cumsum", "sort", "auto"])
def test_bucket_by_dest_groups_and_pads(method):
    vp, n, bcap = 10, 4, 3
    sbuf, sent = buckets_both([25, 5, 29, 31, -1, -1], [7, 8, 9, 10, -1, 11],
                              [3, 4, 5, 6, 0, 2], vp, n, bcap, method=method)
    sbuf = sbuf.reshape(n, bcap, 3)
    assert sent.tolist() == [True] * 4 + [False] * 2
    assert sbuf[0, 0].tolist() == [5, 8, 4]
    assert sbuf[2, :2].tolist() == [[25, 7, 3], [29, 9, 5]]
    assert sbuf[3, 0].tolist() == [31, 10, 6]
    assert (sbuf[1] == -1).all()


@pytest.mark.parametrize("method", ["cumsum", "sort"])
def test_bucket_by_dest_backpressure(method):
    # beyond bcap for one destination: two of four held
    _, sent = buckets_both([15, 16, 17, 18], [0, 1, 2, 3], [1] * 4, 10, 2, 2,
                           method=method)
    assert sent.sum() == 2
    # beyond send_cap in all: three of six held
    sbuf, sent = buckets_both([15, 25, 35, 15, 25, 35], range(6), [1] * 6,
                              10, 4, 8, send_cap=3, method=method)
    assert sent.sum() == 3 and (sbuf[:, 1] >= 0).sum() == 3


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("method", ["cumsum", "sort"])
def test_bucket_by_dest_fuzz(seed, method):
    """tests/test_walks_a2a.py's fuzz: equal to the JAX function, and each
    crosser bucketed to its destination once in index order under bcap and
    send_cap, or held."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(4, 200))
    vp = int(rng.integers(2, 9))
    n = int(rng.integers(2, 9))
    bcap = int(rng.integers(1, 6))
    send_cap = int(rng.integers(1, cap + 1))
    v = rng.integers(-1, vp * n, cap)
    w = rng.integers(-1, 1000, cap)
    t = rng.integers(0, 50, cap)
    sbuf, sent = buckets_both(v, w, t, vp, n, bcap, send_cap=send_cap,
                              method=method)
    sbuf = sbuf.reshape(n, bcap, 3)
    exp_sent = np.zeros(cap, bool)
    exp = {d: [] for d in range(n)}
    n_cand = 0
    for i in range(cap):
        if w[i] < 0 or v[i] < 0 or n_cand >= send_cap:
            continue
        n_cand += 1
        if len(exp[v[i] // vp]) < bcap:
            exp[v[i] // vp].append([v[i], w[i], t[i]])
            exp_sent[i] = True
    np.testing.assert_array_equal(sent, exp_sent)
    for d in range(n):
        k = len(exp[d])
        assert sbuf[d, :k].tolist() == exp[d]
        assert (sbuf[d, k:] == -1).all()


def arrivals_both(cur, wid, t, pend, out, arrivals, length, extra=None,
                  extra_arrivals=None):
    """(port, JAX) place_arrivals outputs as numpy."""
    kw = {}
    if extra is not None:
        kw = dict(extra=extra, extra_arrivals=extra_arrivals)
    args = (cur, wid, t, pend, out, arrivals)
    got = tw.place_arrivals(
        *(torch.as_tensor(np.array(a, np.int32)) for a in args), length,
        **{k: torch.as_tensor(np.array(a, np.int32)) for k, a in kw.items()})
    want = jw.place_arrivals(
        *(jnp.asarray(np.array(a, np.int32)) for a in args), length,
        **{k: jnp.asarray(np.array(a, np.int32)) for k, a in kw.items()})
    got = [np.asarray(x) for x in got]
    for g, wt in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(wt))
    return got


def test_place_arrivals_fills_free_slots_and_records():
    L = 8
    cur2, wid2, t2, _, out2, ov = arrivals_both(
        [5, -1, 7, -1], [0, -1, 1, -1], [3, L, 2, L], [-1] * 4,
        np.zeros((4, L)), [[12, 2, 4], [-1, -1, -1], [13, 3, 7]], L)
    assert ov == 0
    i2 = int(np.where(wid2 == 2)[0][0])
    assert cur2[i2] == 12 and t2[i2] == 5
    assert 3 not in wid2.tolist()  # crossed at its last hop: finished
    assert out2[2, 4] == 13 and out2[3, 7] == 14


def test_place_arrivals_receiver_capacity_overflow():
    *_, ov = arrivals_both([5, 6], [0, 1], [3, 3], [-1, -1],
                           np.zeros((4, 8)), [[12, 2, 4]], 8)
    assert ov == 1


@pytest.mark.parametrize("seed", range(4))
def test_place_arrivals_fuzz(seed):
    """Random residents, pending walkers, padded arrivals and the layer
    column, against the JAX function."""
    rng = np.random.default_rng(seed)
    cap, m, L, W = int(rng.integers(2, 40)), int(rng.integers(0, 40)), 9, 90
    live = rng.random(cap) < 0.5
    wid = np.where(live, rng.permutation(W)[:cap], -1)
    cur = np.where(live, rng.integers(0, 50, cap), -1)
    t = np.where(live, rng.integers(1, L, cap), L)
    pend = np.where(live & (rng.random(cap) < 0.3), rng.integers(0, 50, cap),
                    -1)
    arr = np.stack([rng.integers(0, 50, m), rng.permutation(W)[:m] % W,
                    rng.integers(0, L, m)], 1)
    arr[rng.random(m) < 0.3] = -1
    out = rng.integers(0, 3, (W, L))
    got = arrivals_both(cur, wid, t, pend, out, arr, L, extra=rng.integers(
        0, 5, cap), extra_arrivals=rng.integers(0, 5, m))
    assert len(got) == 7


# ---- Graph methods and the (p,q) budget ---------------------------------


def test_graph_from_csr_free_device_out_weights():
    jg, tg = both_graphs("wiki")
    got = tgraph.Graph.from_csr(tg.row_ptr, tg.col_idx, tg.edge_weight,
                                directed=False)
    want = jgraph.Graph.from_csr(jg.row_ptr, jg.col_idx, jg.edge_weight,
                                 directed=False)
    for k in ("row_ptr", "col_idx", "edge_weight", "degree"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        assert getattr(got, k).dtype == getattr(want, k).dtype
    assert (got.num_nodes, got.num_edges, got.max_degree, got.directed) == (
        want.num_nodes, want.num_edges, want.max_degree, want.directed)
    assert list(got.vocab.idx2node[:3]) == list(want.vocab.idx2node[:3])
    for v in (0, 7, got.num_nodes - 1):
        np.testing.assert_array_equal(got.out_weights(v), want.out_weights(v))
    # its device views build and are dropped by free_device
    cached = got.to("cpu")
    got.neighbor_matrix("cpu")
    got.host_alias()
    assert got.to("cpu") is cached
    got.free_device()
    assert got.to("cpu") is not cached
    assert [k for k in got._views if k[1] is None] == [("alias", None)]
    np.testing.assert_array_equal(got.to("cpu").col_idx.numpy(), tg.col_idx)


@pytest.mark.parametrize("V,dmax,budget", [
    (2405, 139, 4 << 30), (10_000_000, 200, 4 << 30),
    (10_000_000, 200, 8 * (4 << 30)), (20_000_000, 600, 4 << 30),
    (20_000_000, 600, 2 * (4 << 30)), (1000, 5000, 1 << 20)])
def test_select_pq_kernel_budget_equals_jax(V, dmax, budget):
    got = twalk.select_pq_kernel(V, dmax, hbm_budget_bytes=budget)
    assert got == jwalk.select_pq_kernel(V, dmax, hbm_budget_bytes=budget)
    assert twalk.pq_sampler(V, dmax, None, hbm_budget_bytes=budget) == got
