"""The walk kernels' CPU side (K6-K9 of `csrc/walk.cu`): the shared-draws
layout and the dispatch.

On a card each walk is one kernel launch, held against its plain version
on the same uniforms (`draws=`) by `tests/test_torch_card.py` and
`chip_smoke.py`. That comparison rests on the layout checked here: each
plain version given the uniforms `record_draws` takes from a generator,
in the order and shapes of its `*_draw_shapes`, walks exactly what it
walks from a generator in the same state (torch.equal). The layouts'
sizes are those the kernels index (csrc/walk.cu), and on the CPU every
public walk, `simulate_walks`, `Struc2Vec.simulate_walks` and the walker
classes take the plain route, with no kernel count moving. No process is
spawned and nothing is timed.
"""

import numpy as np
import pytest
import torch

from graphembedding_tpu_torch import walker as twalker
from graphembedding_tpu_torch.data import load_dataset, synthetic_wiki
from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.kernels import build as kb
from graphembedding_tpu_torch.models import struc2vec as s2v
from graphembedding_tpu_torch.ops import walk


def gen(seed):
    return torch.Generator().manual_seed(seed)


def small_graph(weighted):
    """A 40-node graph with vertices of degree 0 (dead ends, and one that
    no edge reaches), weights in [0.5, 3) where `weighted`."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, 34, 160)
    dst = rng.integers(0, 38, 160)
    w = (rng.random(160).astype(np.float32) * 2.5 + 0.5) if weighted \
        else None
    return Graph(src, dst, w, num_nodes=40)


def starts_of(g, walks_per_node=3):
    return torch.arange(g.num_nodes, dtype=torch.int64).repeat(
        walks_per_node)


def first_order(kind):
    g = small_graph(kind == "weighted")
    dg = g.to("cpu")
    s = starts_of(g)
    if kind == "uniform":
        return (lambda **kw: walk.uniform_walks_plain(
            dg.row_ptr, dg.col_idx, dg.degree, s, length=7, **kw),
            walk.uniform_draw_shapes(s.shape[0], 7))
    accept, alias = g.alias_tables("cpu")
    return (lambda **kw: walk.weighted_walks_plain(
        dg.row_ptr, dg.col_idx, dg.degree, accept, alias, s, length=7,
        **kw), walk.weighted_draw_shapes(s.shape[0], 7))


def exact():
    g = small_graph(True)
    dg = g.to("cpu")
    nbr, nbr_w = g.neighbor_matrix("cpu")
    s = starts_of(g)
    return (lambda **kw: walk.node2vec_walks_plain(
        dg.degree, nbr, nbr_w, s, 0.25, 4.0, length=7, **kw),
        walk.node2vec_draw_shapes(s.shape[0], 7, nbr.shape[1]))


def rejection(form):
    """The rejection forms: 'csr' (the envelope, CSR membership, alias
    proposals: simulate_walks' 'rejection'), 'dense' (the envelope, dense
    membership, uniform row slots: 'rejection_dense' on an unweighted
    graph), 'dense_alias' (dense membership, alias proposals, weighted)
    and 'bound' (the upper-bound form, CSR membership)."""
    weighted = form in ("csr", "dense_alias")
    g = small_graph(weighted)
    dg = g.to("cpu")
    accept, alias = g.alias_tables("cpu")
    kw = dict(length=7, max_degree=max(dg.max_degree, 1))
    if form != "bound":
        kw.update(edge_weight=dg.edge_weight, wsum=g.weight_sums("cpu"))
    if form.startswith("dense"):
        kw.update(nbr=g.neighbor_ids("cpu"), uniform_rows=form == "dense")
    s = starts_of(g)
    p, q = (0.25, 4.0) if form != "bound" else (2.0, 0.5)
    shapes = walk.rejection_draw_shapes(
        s.shape[0], 7, p, q, envelope=form != "bound",
        row_slots=form == "dense")
    return (lambda **k: walk.node2vec_walks_rejection_plain(
        dg.row_ptr, dg.col_idx, dg.degree, accept, alias, s, p, q, **kw,
        **k), shapes)


def flight_layers():
    g = load_dataset("flight-brazil").graph
    layers = s2v.build_layer_csr(s2v.build_context_graph(g)[0],
                                 g.num_nodes)
    return g.num_nodes, s2v.layers_to(layers, "cpu")


def multilayer():
    V, ly = flight_layers()
    s = torch.arange(V, dtype=torch.int32).repeat(2)
    args = (ly["row_ptr"], ly["col_idx"], ly["accept"], ly["alias"],
            ly["gamma"], s)
    return (lambda generator=None, draws=None: s2v.multilayer_walks_plain(
        *args, generator, 0.3, length=6, draws=draws),
        s2v.multilayer_draw_shapes(s.shape[0], 6))


WALKS = {
    "uniform": lambda: first_order("uniform"),
    "weighted": lambda: first_order("weighted"),
    "exact": exact,
    "rejection_csr": lambda: rejection("csr"),
    "rejection_dense": lambda: rejection("dense"),
    "rejection_dense_alias": lambda: rejection("dense_alias"),
    "rejection_bound": lambda: rejection("bound"),
    "multilayer": multilayer,
}


@pytest.mark.parametrize("kind", list(WALKS))
def test_plain_on_recorded_draws_equals_plain_on_generator(kind):
    """The draws layout is the plain version's own order of draws."""
    run, shapes = WALKS[kind]()
    want = run(generator=gen(5))
    draws = walk.record_draws(shapes, gen(5))
    assert draws.numel() == walk.draw_count(shapes)
    got = run(draws=draws)
    assert torch.equal(got, want)
    # another stream walks another corpus (the draws are really read)
    assert not torch.equal(run(draws=walk.record_draws(shapes, gen(6))),
                           want)


@pytest.mark.parametrize("kind", list(WALKS))
def test_plain_refuses_wrong_draws(kind):
    run, shapes = WALKS[kind]()
    draws = walk.record_draws(shapes, gen(1))
    with pytest.raises(ValueError, match="draws"):
        run(draws=draws[:-1].clone())
    with pytest.raises(ValueError, match="draws"):
        run(draws=draws.double())
    with pytest.raises(ValueError, match="exactly one"):
        run(generator=gen(1), draws=draws)
    with pytest.raises(ValueError, match="exactly one"):
        run()


@pytest.mark.parametrize("B,L", [(5, 10), (192_400, 10), (3, 1), (0, 4)])
def test_draw_layouts_are_the_kernels(B, L):
    """The counts csrc/walk.cu indexes: K6 (L - 1) x B uniforms (two for
    the alias), K7 (L - 1) x B x D, K8 2B + (L - 2) x R x k x B x P, K9
    (L - 1) x (4M + 2) x B."""
    count = walk.draw_count
    hops = max(L - 1, 0)
    assert count(walk.uniform_draw_shapes(B, L)) == hops * B
    assert count(walk.weighted_draw_shapes(B, L)) == 2 * hops * B
    assert count(walk.node2vec_draw_shapes(B, L, 139)) == hops * B * 139
    assert walk.node2vec_draw_shapes(B, L, 139)[:1] in ([], [(B, 139)])
    for envelope, row_slots, k in ((True, False, 4), (True, True, 3),
                                   (False, False, 3), (False, True, 2)):
        P, tries = walk.rejection_budget(0.25, 4.0, envelope=envelope)
        R = -(-tries // P)
        want = 0 if L < 2 else 2 * B + (L - 2) * R * k * B * P
        shapes = walk.rejection_draw_shapes(B, L, 0.25, 4.0,
                                            envelope=envelope,
                                            row_slots=row_slots)
        assert count(shapes) == want
        assert all(s == (B, P) for s in shapes[2:])
    assert count(s2v.multilayer_draw_shapes(B, L)) == hops * 66 * B
    assert count(s2v.multilayer_draw_shapes(B, L, 4)) == hops * 18 * B


def test_rejection_budget_of_the_wiki_phase():
    """p = 0.25, q = 4: the envelope's one round of 22 proposals, the
    upper bound's two rounds of 32 (the 64-try clamp)."""
    assert walk.rejection_budget(0.25, 4.0, envelope=True) == (22, 22)
    assert walk.rejection_budget(0.25, 4.0, envelope=False) == (32, 64)
    a, beta, prev, shared, other = walk.rejection_constants(
        0.25, 4.0, envelope=True)
    assert (a, beta, prev, shared, other) == (3.0, 1.0, 1.0, 1.0, 0.25)
    assert walk.rejection_constants(0.25, 4.0, envelope=False)[2:] == (
        1.0, 0.25, 0.0625)


def test_kernel_entry_points_declared():
    """Each walk kernel's C entry point has its argument types, the
    pointers as void* (a ctypes int would cut them)."""
    sig = kb.SIGNATURES
    assert len(sig["ge_walk_first_order"]) == 14
    assert len(sig["ge_walk_exact_pq"]) == 14
    assert len(sig["ge_walk_rejection_pq"]) == 26
    assert len(sig["ge_walk_multilayer"]) == 19
    import os
    src = open(os.path.join(kb.CSRC, "walk.cu")).read()
    for name in ("ge_walk_first_order", "ge_walk_exact_pq",
                 "ge_walk_rejection_pq", "ge_walk_multilayer"):
        assert f"int {name}(" in src


def counts():
    kernels = {**walk.walk_kernels(), "multilayer_walks": s2v.multilayer_walks}
    return {name: k.launches for name, k in kernels.items()}


@pytest.mark.parametrize("kind,sampler", [
    ("uniform", None), ("weighted", None), ("node2vec", "exact"),
    ("node2vec", "rejection_dense"), ("node2vec", "rejection")])
def test_simulate_walks_on_cpu_takes_the_plain_route(kind, sampler):
    g = small_graph(kind == "weighted")
    before = counts()
    got = walk.simulate_walks(g, 2, 6, generator=gen(3), kind=kind, p=0.25,
                              q=4.0, sampler=sampler)
    assert counts() == before
    starts = starts_of(g, 2)
    dg = g.to("cpu")
    if kind == "uniform":
        want = walk.uniform_walks_plain(dg.row_ptr, dg.col_idx, dg.degree,
                                        starts, length=6, generator=gen(3))
        assert torch.equal(got, want)
    assert got.shape == (2 * g.num_nodes, 6) and got.dtype == torch.int32


def test_struc2vec_and_walkers_on_cpu_take_the_plain_route(tmp_path):
    from graphembedding_tpu_torch.models.struc2vec import Struc2Vec

    g = synthetic_wiki(num_nodes=40, num_classes=2, seed=1).graph
    before = counts()
    m = Struc2Vec(g, walk_length=5, num_walks=2, temp_path=str(tmp_path),
                  device="cpu")
    ly = m.layers
    want = s2v.multilayer_walks_plain(
        ly["row_ptr"], ly["col_idx"], ly["accept"], ly["alias"],
        ly["gamma"], torch.arange(40, dtype=torch.int32).repeat(2),
        torch.Generator().manual_seed(m.seed), 0.3, length=5)
    assert torch.equal(m.walks, want)
    assert torch.equal(m.simulate_walks(), want)
    rw = twalker.RandomWalker(g, p=0.25, q=4.0, device="cpu")
    assert len(rw.simulate_walks(2, 5, seed=1)) == 80
    bw = twalker.BiasedWalker(list(range(40)), str(tmp_path), device="cpu")
    assert len(bw.simulate_walks(2, 5, seed=1)) == 80
    assert counts() == before


def test_mixed_devices_refused():
    g = small_graph(False)
    dg = g.to("cpu")
    meta = torch.arange(4, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        walk.uniform_walks(dg.row_ptr, dg.col_idx, dg.degree, meta,
                           length=3, generator=gen(0))
