"""The port's distributed walk engines at 2 ranks against graphembedding_tpu.

The JAX side runs on 2 of conftest's 8 virtual CPU devices
(`make_mesh(..., devices=jax.devices()[:2])`); the port's on 2 gloo
processes with one torch thread each (`parallel.launch.run_ranks`). One
spawn runs every case (`engine_cases`); each test reads its own. jax is
imported inside functions only: the spawned ranks import this module.

- Exact equality: the route compaction and the int32 row fetch against
  JAX's `_route` and `_fetch_rows_i32` under shard_map, from the same
  fields; `comm.ragged_all_to_all` with uneven and empty splits; the
  ragged a2a exchange against the dense frame (`dense_exchange`, the JAX
  package's), whole corpora torch.equal, at the default bucket cap and at
  caps small enough to force backpressure rounds, for the uniform,
  weighted (hop_batch 2) and multilayer engines.
- Distribution, every kind: every hop an edge (or a stay in a layer for
  multilayer), full start coverage, no loss, and visit frequencies against
  the JAX engines' and the port's single-device samplers' within the L1
  bounds of tests/test_parallel.py:574-816 and tests/test_walks_a2a.py (0.08
  for first-order, 0.1 for rejection and multilayer); transitions: a
  weighted star's hub against its weights (atol 0.045), a star's hub
  uniform (0.05), the exact (p,q) second step on a triangle with a tail
  (0.035), for the exact and the rejection engine.
- The Zipf hub graph: no walker lost at slack 4 (all-gather engine), and
  backpressure with a bucket cap of 2 (a2a) and send_slack 1 (batched).
- Same seed, same corpus; the DistributedWalker's refusals.
"""

import numpy as np
import pytest
import torch

from graphembedding_tpu_torch.parallel.launch import run_ranks

N = 2
L = 12


def zipf_edges(V=64, seed=0):
    """tests/test_walks_a2a.py's hub graph (shard 0 owns the hubs)."""
    rng = np.random.default_rng(seed)
    edges = {(i, (i + 1) % V) for i in range(V)}
    for hub, fan in enumerate([V // 2, V // 4, V // 8, V // 16]):
        for t in rng.choice(V, fan, replace=False):
            t = int(t)
            if t != hub:
                edges.add((min(hub, t), max(hub, t)))
    src, dst = map(np.asarray, zip(*sorted(edges)))
    return src, dst


def rejection_hub_edges():
    """tests/test_parallel.py:778's graph: a ring of 400 and a hub of
    degree ~300 (Dmax >> the median degree)."""
    rng = np.random.default_rng(0)
    V = 400
    src = list(range(V))
    dst = [(i + 1) % V for i in range(V)]
    for t in rng.choice(V, 300, replace=False):
        if t != 0:
            src += [0, int(t)]
            dst += [int(t), 0]
    return np.array(src + dst), np.array(dst + src), V


def graphs(pkg):
    """The test graphs, built by `pkg` (the port or the JAX package)."""
    import importlib

    G = importlib.import_module(f"{pkg}.graph").Graph
    ds = importlib.import_module(f"{pkg}.data.datasets")
    k6 = np.arange(1, 7)
    src, dst, V = rejection_hub_edges()
    return {
        "wiki": ds.synthetic_wiki(num_nodes=200, num_classes=4,
                                  avg_degree=6, seed=3).graph,
        "zipf": G(*zipf_edges(), directed=False),
        "zipf48": G(*zipf_edges(48, 1), directed=False),
        "wstar": G(np.zeros(6, int), k6, k6.astype(np.float32),
                   directed=False),
        "star": G(np.zeros(9, int), np.arange(1, 10), directed=False),
        "tri": G(np.array([0, 1, 2, 2]), np.array([1, 2, 0, 3]),
                 directed=False),
        "hub": G(src, dst, num_nodes=V, directed=False),
    }


def layers_of(g):
    """The Struc2Vec layer CSRs of a port graph (numpy)."""
    from graphembedding_tpu_torch.models.struc2vec import (
        build_context_graph,
        build_layer_csr,
    )

    return build_layer_csr(build_context_graph(g)[0], g.num_nodes)


# (graph, DistributedWalker keywords, seed) of each walk case
WALKS = {
    "uniform": ("wiki", dict(num_walks=40)),
    "weighted": ("wiki", dict(kind="weighted", num_walks=40)),
    "batched": ("wiki", dict(num_walks=40, hop_batch=4)),
    "a2a": ("wiki", dict(num_walks=40, exchange="a2a")),
    "a2a_weighted": ("wiki", dict(kind="weighted", num_walks=40,
                                  exchange="a2a", hop_batch=2)),
    "node2vec": ("wiki", dict(kind="node2vec", num_walks=40, p=0.25, q=4.0)),
    "rejection": ("hub", dict(kind="node2vec_rejection", num_walks=40,
                              p=0.25, q=4.0, slack=8)),
    "relabel": ("wiki", dict(num_walks=5, hop_batch=2, relabel="locality")),
    "zipf_slack4": ("zipf", dict(num_walks=30, slack=4)),
    "zipf_a2a": ("zipf", dict(num_walks=30, exchange="a2a", slack=8,
                              bucket_cap=2)),
    "zipf_batched": ("zipf", dict(num_walks=30, hop_batch=4, slack=8,
                                  send_slack=1.0)),
    "wstar": ("wstar", dict(kind="weighted", num_walks=800, slack=16)),
    "wstar_a2a": ("wstar", dict(kind="weighted", num_walks=600, slack=16,
                                exchange="a2a")),
    "star_a2a": ("star", dict(num_walks=400, slack=16, exchange="a2a")),
    "tri_exact_fast": ("tri", dict(kind="node2vec", num_walks=6000, p=0.25,
                                   q=4.0)),
    "tri_exact_slow": ("tri", dict(kind="node2vec", num_walks=6000, p=4.0,
                                   q=0.25)),
    "tri_rejection": ("tri", dict(kind="node2vec_rejection", num_walks=6000,
                                  p=0.25, q=4.0)),
    "multilayer": ("zipf48", dict(kind="multilayer", num_walks=40,
                                  slack=8)),
    "multilayer_a2a": ("zipf48", dict(kind="multilayer", num_walks=40,
                                      slack=8, exchange="a2a")),
}
LENGTH = {"wstar": 2, "wstar_a2a": 2, "star_a2a": 2, "tri_exact_fast": 3,
          "tri_exact_slow": 3, "tri_rejection": 3, "multilayer": 8,
          "multilayer_a2a": 8, "zipf_slack4": 10, "zipf_a2a": 10,
          "zipf_batched": 10}


# ---- the port's side: runs in each spawned rank (no jax here) ----------

def _frames(mesh, g, layers):
    """The ragged exchange against the dense frame: the whole corpus of
    each a2a engine from one seed, at the default bucket cap and at small
    ones (backpressure rounds)."""
    from graphembedding_tpu_torch.parallel import walks as tw
    from graphembedding_tpu_torch.parallel.mesh import rank_seed

    me = mesh.get_local_rank("data")
    V = g.num_nodes
    vp = -(-V // N)
    accept, alias = g.host_alias()
    parts = tw.partition_csr(g, N, edge_arrays={
        "accept": (accept, 1.0), "alias": (alias, 0)})
    Vl = layers["gamma"].shape[1]
    lparts = tw.partition_layers(layers, Vl, N)
    out = {}
    for name, bcap, weighted, multilayer in (
            ("uniform", None, False, False), ("uniform_bcap4", 4, False,
                                              False),
            ("weighted_bcap8", 8, True, False), ("multilayer", None, False,
                                                 True),
            ("multilayer_bcap2", 2, False, True)):
        runs = []
        for ex in (tw.ragged_exchange, tw.dense_exchange):
            if multilayer:
                starts, nw = tw._group_starts(Vl, 10, N, -(-Vl // N))
                fn = tw.distributed_multilayer_walks_a2a(
                    mesh, length=8, vp=-(-Vl // N), n_walkers=nw,
                    stay_prob=0.3, slack=8, bucket_cap=bcap, exchange=ex)
                args = [torch.as_tensor(lparts[k][me]) for k in (
                    "row_ptr", "col_idx", "accept", "alias", "gamma")]
            else:
                starts, nw = tw._group_starts(V, 10, N, vp)
                fn = tw.distributed_uniform_walks_a2a(
                    mesh, length=L, vp=vp, n_walkers=nw, bucket_cap=bcap,
                    weighted=weighted, hop_batch=2 if weighted else 1,
                    exchange=ex)
                keys = ("row_ptr", "col_idx", "degree") + (
                    ("accept", "alias") if weighted else ())
                args = [torch.as_tensor(parts[k][me]) for k in keys]
            gen = torch.Generator().manual_seed(rank_seed(11, me))
            walks, ov, rounds, crossed = fn(
                *args, torch.as_tensor(starts[me]), gen)
            runs.append((walks, int(ov), rounds, int(crossed)))
        (a, *ra), (b, *rb) = runs
        out[name] = dict(equal=torch.equal(a, b), ragged=ra, dense=rb,
                         valid=int((a[:, 0] >= 0).sum()))
    return out


def _refusals(mesh, g):
    from graphembedding_tpu_torch.parallel.walks import (
        DistributedWalker,
        distributed_multilayer_walks_a2a,
    )

    out = {}
    for name, fn in (
            ("relabel", lambda: DistributedWalker(
                g, mesh, 4, kind="weighted", relabel="locality")),
            ("route_off", lambda: DistributedWalker(
                g, mesh, 4, kind="node2vec", route_off=True)),
            ("exchange", lambda: DistributedWalker(g, mesh, 4,
                                                   exchange="ragged")),
            ("a2a_kind", lambda: DistributedWalker(
                g, mesh, 4, kind="node2vec", exchange="a2a")),
            ("kind", lambda: DistributedWalker(g, mesh, 4, kind="levy")),
            ("pack", lambda: distributed_multilayer_walks_a2a(
                mesh, length=1 << 16, vp=4, n_walkers=8, stay_prob=0.3))):
        try:
            fn()
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def engine_cases(info, cases):
    from graphembedding_tpu_torch.ops.walk import simulate_walks
    from graphembedding_tpu_torch.parallel import comm
    from graphembedding_tpu_torch.parallel import walks as tw
    from graphembedding_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((N, 1), device="cpu")
    me = mesh.get_local_rank("data")
    group = mesh.get_group("data")
    gs = graphs("graphembedding_tpu_torch")
    layers = layers_of(gs["zipf48"])
    out = {}

    # routing primitives on the JAX test's fields
    r = cases["route"]
    fields = [torch.as_tensor(f[me]) for f in r["fields"]]
    got, ov = tw._route(fields, me * r["vp"], r["vp"], r["cap"], group)
    out["route"] = ([f.numpy() for f in got], int(ov))
    f = cases["fetch"]
    out["fetch"] = tw._fetch_rows_i32(
        torch.as_tensor(f["rows"][me]), torch.as_tensor(f["ids"][me]),
        me * f["vp"], f["vp"], group).numpy()
    # ragged all-to-all: rank 0 sends 0 and 3 rows, rank 1 2 and 0
    frame = torch.arange(24, dtype=torch.int32).view(2, 4, 3) + 100 * me
    counts = torch.tensor([[0, 3], [2, 0]][me])
    rows, recv, extra = comm.ragged_all_to_all(
        frame, counts, group, extra=torch.tensor([[10 * me], [10 * me + 1]]))
    out["ragged"] = (rows.numpy(), recv, extra)

    out["frames"] = _frames(mesh, gs["wiki"], layers)
    out["refusals"] = _refusals(mesh, gs["wiki"])

    walks = {}
    for name, (gname, kw) in WALKS.items():
        kw = dict(kw)
        if kw.get("kind") == "multilayer":
            kw.update(layers=layers, num_nodes=gs[gname].num_nodes)
            graph = None
        else:
            graph = gs[gname]
        w = tw.DistributedWalker(graph, mesh, LENGTH.get(name, L), **kw)
        corpus, ov = w.run(3)
        walks[name] = (corpus, ov, w.last_rounds, w.last_crossed)
        if name == "a2a":
            again, _ = w.run(3)
            other, _ = w.run(4)
            out["determinism"] = (np.array_equal(corpus, again),
                                  np.array_equal(corpus, other))
    out["walks"] = walks if me == 0 else {
        k: v[1:] for k, v in walks.items()}  # rank 1: counts only
    out["corpus_equal"] = {k: v[0] for k, v in walks.items()
                           if k in ("uniform", "a2a", "multilayer")}

    # the single-device samplers on the same graphs (rank 0 only)
    if me == 0:
        gen = torch.Generator().manual_seed(5)
        single = {}
        for name in ("uniform", "weighted", "node2vec"):
            _, kw = WALKS[name]
            kind = kw.get("kind", "uniform")
            single[name] = simulate_walks(
                gs["wiki"], 40, L, generator=gen, kind=kind, p=kw.get("p", 1),
                q=kw.get("q", 1)).numpy()
        single["hub"] = simulate_walks(gs["hub"], 40, L, generator=gen,
                                       kind="node2vec", p=0.25,
                                       q=4.0).numpy()
        single["zipf"] = simulate_walks(gs["zipf"], 30, 10,
                                        generator=gen).numpy()
        from graphembedding_tpu_torch.models.struc2vec import (
            layers_to,
            multilayer_walks,
        )

        ly = layers_to(layers, "cpu")
        V48 = gs["zipf48"].num_nodes
        single["multilayer"] = multilayer_walks(
            ly["row_ptr"], ly["col_idx"], ly["accept"], ly["alias"],
            ly["gamma"], torch.arange(V48, dtype=torch.int32).repeat(40),
            gen, 0.3, length=8).numpy()
        out["single"] = single
    return out


# ---- the JAX side, and the comparison ---------------------------------

def _jax_side():
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from graphembedding_tpu.parallel import walks as jw
    from graphembedding_tpu.parallel.mesh import make_mesh

    mesh = make_mesh((N, 1), devices=jax.devices()[:N])
    rng = np.random.default_rng(0)
    cases, want = {}, {}

    # route: 3 fields a rank, field 0 the next vertex (-1 dead), with more
    # walkers bound for rank 1 than its cap so that it overflows
    vp, cap = 10, 12
    nxt = rng.integers(-1, 2 * vp, (N, cap)).astype(np.int32)
    nxt[0, :9] = rng.integers(vp, 2 * vp, 9)
    fields = [nxt, rng.integers(0, 99, (N, cap)).astype(np.int32),
              rng.integers(-1, 9, (N, cap)).astype(np.int32)]

    def route_body(a, b, c):
        lo = jax.lax.axis_index("data") * vp
        got, ov = jw._route([a[0], b[0], c[0]], lo, vp, cap, N, "data")
        return tuple(x[None] for x in got) + (ov[None],)

    fn = shard_map(route_body, mesh=mesh, in_specs=(P("data"),) * 3,
                   out_specs=(P("data"),) * 4, check_vma=False)
    got = [np.asarray(x) for x in fn(*map(jnp.asarray, fields))]
    cases["route"] = dict(fields=fields, vp=vp, cap=cap)
    want["route"] = got

    # fetch: padded int32 rows, ids on both ranks with -1 pads
    W = 5
    rows = rng.integers(-1, 50, (N, vp, W)).astype(np.int32)
    ids = rng.integers(-1, 2 * vp, (N, cap)).astype(np.int32)

    def fetch_body(r, i):
        lo = jax.lax.axis_index("data") * vp
        return jw._fetch_rows_i32(r[0], i[0], lo, vp, "data")[None]

    fn = shard_map(fetch_body, mesh=mesh, in_specs=(P("data"),) * 2,
                   out_specs=P("data"), check_vma=False)
    cases["fetch"] = dict(rows=rows, ids=ids, vp=vp)
    want["fetch"] = np.asarray(fn(jnp.asarray(rows), jnp.asarray(ids)))

    # the JAX engines' corpora for the visit frequencies
    gs = graphs("graphembedding_tpu")
    from graphembedding_tpu.models.struc2vec import (
        build_context_graph,
        build_layer_csr,
    )

    g48 = gs["zipf48"]
    jlayers = build_layer_csr(build_context_graph(g48)[0], g48.num_nodes)
    jwalks = {}
    for name in ("uniform", "weighted", "batched", "a2a", "a2a_weighted",
                 "node2vec", "rejection", "multilayer", "multilayer_a2a"):
        gname, kw = WALKS[name]
        kw = dict(kw)
        graph = gs[gname]
        if kw.get("kind") == "multilayer":
            kw.update(layers=jlayers, num_nodes=g48.num_nodes)
            graph = None
        w = jw.DistributedWalker(graph, mesh, LENGTH.get(name, L), **kw)
        jwalks[name] = w.run(jax.random.PRNGKey(7))[0]
    want["walks"] = jwalks
    return cases, want


@pytest.fixture(scope="module")
def results():
    cases, want = _jax_side()
    got = run_ranks(engine_cases, N, cases, timeout_s=600)
    return want, got


def visits(walks, V):
    f = np.bincount(walks[walks >= 0].ravel(), minlength=V)
    return f / f.sum()


def l1(a, b, V):
    return float(np.abs(visits(a, V) - visits(b, V)).sum())


def test_route_compaction_equals_jax(results):
    want, got = results
    for r in range(N):
        fields, ov = got[r]["route"]
        for f, w in zip(fields, want["route"][:3]):
            np.testing.assert_array_equal(f, w[r])
        assert ov == int(want["route"][3][r])
    assert int(want["route"][3].sum()) > 0  # the case does overflow


def test_fetch_rows_equals_jax(results):
    want, got = results
    for r in range(N):
        np.testing.assert_array_equal(got[r]["fetch"], want["fetch"][r])
    assert (want["fetch"] == 0).all(axis=-1).any()  # -1 ids: zero rows


def test_ragged_all_to_all_uneven_and_empty_splits(results):
    _, got = results
    rows0, recv0, extra0 = got[0]["ragged"]
    rows1, recv1, extra1 = got[1]["ragged"]
    assert recv0 == [0, 2] and recv1 == [3, 0]
    # rank 0 gets rank 1's bucket 0, rank 1 rank 0's bucket 1
    np.testing.assert_array_equal(rows0, np.arange(6).reshape(2, 3) + 100)
    np.testing.assert_array_equal(rows1, np.arange(12, 21).reshape(3, 3))
    assert extra0 == [[0], [10]] and extra1 == [[1], [11]]


@pytest.mark.parametrize("name", ["uniform", "uniform_bcap4",
                                  "weighted_bcap8", "multilayer",
                                  "multilayer_bcap2"])
def test_ragged_exchange_equals_dense_frame(results, name):
    _, got = results
    for r in range(N):
        f = got[r]["frames"][name]
        assert f["equal"], (r, f)
        assert f["ragged"] == f["dense"]  # overflow, rounds, crossed
        ov, rounds, crossed = f["ragged"]
        assert ov == 0 and crossed > 0 and f["valid"] > 0
    # small bucket caps cost rounds: backpressure, not loss
    base = got[0]["frames"]["uniform"]["ragged"][1]
    assert got[0]["frames"]["uniform_bcap4"]["ragged"][1] > base
    assert got[0]["frames"]["multilayer_bcap2"]["ragged"][1] > \
        got[0]["frames"]["multilayer"]["ragged"][1]


def check_hops(walks, g, layered=None):
    """Every hop an edge of g (or, for multilayer, of some layer, or a stay
    at a vertex without an edge in some layer), tokens a prefix."""
    nbrs = {v: set(g.neighbors(v).tolist()) for v in range(g.num_nodes)}
    for row in walks:
        toks = row[row >= 0]
        assert (row[: len(toks)] >= 0).all()
        for a, b in zip(toks[:-1], toks[1:]):
            if layered is None:
                assert b in nbrs[int(a)], (a, b)
            else:
                assert b in layered[int(a)], (a, b)


def layer_moves(layers, V):
    """For multilayer walks: the vertices reachable in one emission."""
    rp, col = layers["row_ptr"], layers["col_idx"]
    out = {v: set() for v in range(V)}
    for k in range(rp.shape[0]):
        for v in range(V):
            row = col[k, rp[k, v]: rp[k, v + 1]]
            out[v].update(row.tolist())
            if row.size == 0:
                out[v].add(v)
    return out


@pytest.mark.parametrize("name", sorted(WALKS))
def test_engine_walks_are_valid(results, name):
    _, got = results
    corpus, ov, rounds, crossed = got[0]["walks"][name]
    gname, kw = WALKS[name]
    g = graphs("graphembedding_tpu_torch")[gname]
    assert ov == 0 and got[1]["walks"][name][0] == 0
    nw = kw["num_walks"]
    assert corpus.shape == (nw * g.num_nodes, LENGTH.get(name, L))
    np.testing.assert_array_equal(
        np.bincount(corpus[:, 0], minlength=g.num_nodes), nw)
    if kw.get("kind") == "multilayer":
        assert (corpus >= 0).all()  # forced steps: no walk ends early
        check_hops(corpus, g, layer_moves(layers_of(g), g.num_nodes))
    else:
        check_hops(corpus, g)
    if kw.get("exchange") == "a2a" or kw.get("hop_batch"):
        assert rounds >= 1
    if kw.get("exchange") == "a2a":
        assert crossed > 0
    if name == "zipf_a2a":  # bucket cap 2: many retry rounds
        assert rounds > 9


@pytest.mark.parametrize("name,bound", [
    ("uniform", 0.08), ("weighted", 0.08), ("batched", 0.08), ("a2a", 0.08),
    ("a2a_weighted", 0.08), ("node2vec", 0.08), ("rejection", 0.1),
    ("multilayer", 0.1), ("multilayer_a2a", 0.1)])
def test_visit_frequencies_match_jax_and_single_device(results, name,
                                                       bound):
    want, got = results
    corpus = got[0]["walks"][name][0]
    gname = WALKS[name][0]
    V = graphs("graphembedding_tpu_torch")[gname].num_nodes
    assert l1(corpus, want["walks"][name], V) < bound
    single = got[0]["single"]
    key = {"batched": "uniform", "a2a": "uniform",
           "a2a_weighted": "weighted", "rejection": "hub",
           "multilayer_a2a": "multilayer"}.get(name, name)
    assert l1(corpus, single[key], V) < bound


def test_zipf_hub_no_loss_at_slack_4(results):
    _, got = results
    corpus, ov, *_ = got[0]["walks"]["zipf_slack4"]
    assert ov == 0
    np.testing.assert_allclose(visits(corpus, 64),
                               visits(got[0]["single"]["zipf"], 64),
                               atol=0.02)


@pytest.mark.parametrize("name,atol", [("wstar", 0.045),
                                       ("wstar_a2a", 0.04)])
def test_weighted_hub_transitions(results, name, atol):
    _, got = results
    walks = got[0]["walks"][name][0]
    hub = walks[walks[:, 0] == 0]
    freq = np.bincount(hub[:, 1], minlength=7)[1:]
    w = np.arange(1, 7)
    np.testing.assert_allclose(freq / freq.sum(), w / w.sum(), atol=atol)


def test_uniform_hub_transitions(results):
    _, got = results
    walks = got[0]["walks"]["star_a2a"][0]
    freq = np.bincount(walks[walks[:, 0] == 0][:, 1], minlength=10)[1:]
    np.testing.assert_allclose(freq / freq.sum(), 1 / 9, atol=0.05)


@pytest.mark.parametrize("name,p,q", [("tri_exact_fast", 0.25, 4.0),
                                      ("tri_exact_slow", 4.0, 0.25),
                                      ("tri_rejection", 0.25, 4.0)])
def test_second_order_transitions(results, name, p, q):
    """The (p,q) second step from (0, mid) on the triangle with a tail
    (tests/test_parallel.py:596), whose rows live on both ranks."""
    _, got = results
    g = graphs("graphembedding_tpu_torch")["tri"]
    walks = got[0]["walks"][name][0]
    start0 = walks[walks[:, 0] == 0]
    checked = 0
    for mid in (1, 2):
        sel = start0[start0[:, 1] == mid]
        if len(sel) < 1000:
            continue
        nbrs, w = g.neighbors(mid), g.out_weights(mid).astype(np.float64)
        prev_nbrs = set(g.neighbors(0).tolist())
        bias = np.array([1 / p if x == 0 else 1.0 if x in prev_nbrs
                         else 1 / q for x in nbrs])
        target = w * bias / (w * bias).sum()
        freq = np.bincount(sel[:, 2], minlength=g.num_nodes)[nbrs]
        np.testing.assert_allclose(freq / freq.sum(), target, atol=0.035)
        checked += 1
    assert checked


def test_ranks_hold_the_same_corpus_and_seed_determinism(results):
    _, got = results
    for name in got[0]["corpus_equal"]:
        np.testing.assert_array_equal(got[0]["corpus_equal"][name],
                                      got[1]["corpus_equal"][name])
    for r in range(N):
        assert got[r]["determinism"] == (True, False)


@pytest.mark.parametrize("case,match", [
    ("relabel", "relabel"), ("route_off", "route_off"),
    ("exchange", "unknown exchange"), ("a2a_kind", "exchange='a2a'"),
    ("kind", "unknown distributed walk kind"), ("pack", "2\\^16")])
def test_walker_refusals(results, case, match):
    import re

    _, got = results
    for r in range(N):
        msg = got[r]["refusals"][case]
        assert msg is not None and re.search(match, msg), msg
