"""Port's mesh chunks against graphembedding_tpu/parallel/ at 2 ranks.

The JAX chunks run on 2 of conftest's 8 virtual CPU devices
(`make_mesh(..., devices=jax.devices()[:2])`); the port's on 2 gloo
processes with one torch thread each (`parallel.launch.run_ranks`), from the
same weights and on the draws the JAX bodies make (rowshard.py:177-183,
sgns.py:90-94, hsoftmax.py:76, line.py:81), reproduced here with the same
`jax.random` calls and handed to the port. One spawn runs every case
(`port_cases`); each test reads its own.

Tolerances, those of the single-device parity tests of each step:
- the row fetch: bit-exact; the push buffers: rtol 1e-6 (sums of two
  rows in another order);
- SGNS chunks (rowshard, dp at (2, 1) and (1, 2)): tables rtol 1e-4, atol
  1e-6, losses rtol 1e-4 (tests/test_torch_skipgram.py: K1's plain
  version sums its products in another order than XLA's einsums);
- HS and LINE chunks: rtol 1e-5, atol 1e-6 (tests/test_torch_hsoftmax.py,
  tests/test_torch_line.py).

jax is imported inside the fixture only: the spawned ranks import this
module, and must not load it.
"""

import numpy as np
import pytest
import torch

from graphembedding_tpu_torch.interop import (
    rowshard_tables_from_jax,
    rowshard_tables_to_numpy,
)
from graphembedding_tpu_torch.parallel.launch import run_ranks

N = 2  # ranks
V, D, L, NW, BW, S, K, W, NSP = 41, 16, 8, 96, 32, 4, 8, 3, 2
T0, TOTAL, CAP = 5, 20.0, 8.0


# ---- the port's side: runs in each spawned rank (no jax here) ----------

def _cols(mesh, width):
    m, mi = mesh.size("model"), mesh.get_local_rank("model")
    return slice(mi * width // m, (mi + 1) * width // m)


def _port_case(meshes, kind, c):
    from graphembedding_tpu_torch.parallel import (
        hsoftmax,
        line,
        rowshard,
        sgns,
    )

    t = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in c.items()}
    mesh = meshes[c.get("mesh", (N, 1))]
    di = mesh.get_local_rank("data")
    if kind == "fetch_push":
        Vp = t["w"].shape[0] // N
        lo = di * Vp
        w_local = t["w"][lo:lo + Vp].clone()
        ids = t["ids"][di]
        local, owned = rowshard.gather_ids(ids, lo, Vp, mesh.get_group("data"))
        rows = rowshard.fetch_rows_with(w_local, ids, local, owned,
                                        mesh.get_group("data"))
        buf = rowshard.push_grads_with(Vp, local, owned, rows,
                                       mesh.get_group("data"))
        return rows.numpy(), buf.numpy()
    if kind == "rowshard":
        w_local = rowshard_tables_from_jax(c["w"], N)[di]
        out = rowshard.rowsharded_sgns_chunk(
            w_local, t["walks"], t["eff"][di], t["negs"][di], 0.025, 1e-4,
            T0, TOTAL, mesh=mesh, block_walks=BW, window=W, negative=5,
            neg_share_packs=NSP, update_cap=CAP, prefetch=c["prefetch"])
        return tuple(x.numpy() for x in out)
    if kind == "dp":
        cols = _cols(mesh, D)
        w_cat = torch.cat([t["w_in"][:, cols], t["w_out"][:, cols]], 1)
        out = sgns.sharded_sgns_chunk(
            w_cat, t["walks"], t["eff"], t["negs"][di], 0.025, 1e-4, T0,
            TOTAL, mesh=mesh, block_walks=BW, window=W, negative=5,
            neg_share_packs=NSP, update_cap=CAP, sync_every=2)
        return tuple(x.numpy() for x in out)
    if kind == "hs":
        cols = _cols(mesh, D)
        out = hsoftmax.sharded_hs_chunk(
            t["w_in"][:, cols].clone(), t["w_tree"][:, cols].clone(),
            t["walks"], t["points"], t["codes"], t["eff"][di], 0.025, 1e-4,
            T0, TOTAL, mesh=mesh, block_walks=BW, window=W, update_cap=CAP,
            sync_every=2)
        return tuple(x.numpy() for x in out)
    if kind == "line":
        ctx = None if c["ctx"] is None else t["ctx"].clone()
        emb, ctx, losses = line.sharded_line_chunk(
            t["emb"].clone(), ctx, *(torch.from_numpy(x[di])
                                     for x in c["draws"]), mesh=mesh,
            negative=5, k_shared=c["k_shared"], update_cap=CAP, sync_every=2)
        return emb.numpy(), None if ctx is None else ctx.numpy(), \
            losses.numpy()
    if kind == "line_model_axis":
        try:
            line.local_batch(mesh, 64)
        except ValueError as e:
            return str(e)
        return None
    raise ValueError(kind)


def port_cases(info, cases):
    from graphembedding_tpu_torch.parallel.mesh import make_mesh

    meshes = {(N, 1): make_mesh((N, 1), device="cpu"),
              (1, N): make_mesh((1, N), device="cpu")}
    return {name: _port_case(meshes, kind, c)
            for name, (kind, c) in cases.items()}


# ---- the JAX side, and the comparison ---------------------------------

def _jax_cases():
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from graphembedding_tpu.models import line as jline
    from graphembedding_tpu.parallel import hsoftmax as jhs
    from graphembedding_tpu.parallel import line as jpl
    from graphembedding_tpu.parallel import rowshard as jrs
    from graphembedding_tpu.parallel import sgns as jsg
    from graphembedding_tpu.parallel.mesh import make_mesh
    from graphembedding_tpu.train import skipgram as jtrain
    from graphembedding_tpu.train.hsoftmax import build_huffman
    from graphembedding_tpu_torch.parallel.rowshard import rank_geometry
    from graphembedding_tpu_torch.parallel.sgns import dp_geometry

    devs = jax.devices()[:N]
    meshes = {(N, 1): make_mesh((N, 1), devices=devs),
              (1, N): make_mesh((1, N), devices=devs)}
    rng = np.random.default_rng(0)
    walks = rng.integers(0, V, (NW, L)).astype(np.int32)
    cut = rng.integers(2, L, NW)
    walks[(np.arange(L)[None] >= cut[:, None])
          & (rng.random(NW) < 0.2)[:, None]] = -1
    neg_table = jnp.asarray(jtrain.negative_table(
        jtrain.corpus_counts(walks, V), 0.75, 1 << 10))
    key = jax.random.PRNGKey(9)
    f32, i32 = jnp.float32, jnp.int32
    sched = (f32(0.025), f32(1e-4), i32(T0), f32(TOTAL))
    cases, want = {}, {}

    # fetch and push on ragged ownership: rank 0 asks mostly for rank 1's
    # rows, rank 1 only for its own, both with pads
    Vp, C, T = 5, 6, 12
    w = rng.standard_normal((N * Vp, C)).astype(np.float32)
    ids = np.stack([rng.choice([0, 5, 6, 7, 8, 9, -1], T),
                    rng.choice([5, 6, 9, -1], T)]).astype(np.int32)

    def fp_body(w_local, ids_local):
        lo = jax.lax.axis_index("data") * Vp
        rows = jrs.fetch_rows(w_local, ids_local[0], lo, "data")
        buf = jrs.push_grads(w_local, ids_local[0], rows, lo, "data")
        return rows[None], buf

    fp = shard_map(fp_body, mesh=meshes[(N, 1)],
                   in_specs=(P("data"), P("data")),
                   out_specs=(P("data"), P("data")), check_vma=False)
    rows, buf = fp(jnp.asarray(w), jnp.asarray(ids))
    cases["fetch_push"] = ("fetch_push", dict(w=w, ids=ids))
    want["fetch_push"] = (np.asarray(rows), np.asarray(buf))

    w_in = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.fold_in(key, T0))

    def effs(k, shape):
        return np.array(W - (jax.random.uniform(k, shape) * W).astype(
            jnp.int32).clip(0, W - 1))

    def negs(k, shape):
        return np.array(neg_table[jax.random.randint(
            k, shape, 0, neg_table.shape[0], dtype=jnp.int32)])

    # rowshard: the padded [N * Vp, 2D] table; both draws folded by rank
    geo = rank_geometry(NW, L, BW, N, NSP)
    Vp = -(-V // N)
    w_cat = np.zeros((N * Vp, 2 * D), np.float32)
    w_cat[:V] = np.concatenate([w_in, w_out], 1)
    rs_eff = np.stack([effs(jax.random.fold_in(k1, r), (S, geo.G, geo.PL))
                       for r in range(N)])
    rs_negs = np.stack([negs(jax.random.fold_in(k2, r), (S, geo.G2, K))
                        for r in range(N)])
    for prefetch in (False, True):
        fn = jrs.rowsharded_sgns_chunk(
            meshes[(N, 1)], chunk_steps=S, block_walks=BW, window=W,
            negative=5, k_shared=K, update_cap=CAP, neg_share_packs=NSP,
            prefetch=prefetch)
        got = fn(jnp.asarray(w_cat), jnp.asarray(walks), neg_table, key,
                 *sched)
        name = f"rowshard_prefetch{int(prefetch)}"
        cases[name] = ("rowshard", dict(w=w_cat, walks=walks, eff=rs_eff,
                                        negs=rs_negs, prefetch=prefetch))
        want[name] = tuple(np.asarray(x) for x in got)

    # dp: eff shared by the data ranks, the negatives folded by data rank
    for shape in ((N, 1), (1, N)):
        geo = dp_geometry(NW, L, BW, shape[0], NSP)
        fn = jsg.sharded_sgns_chunk(
            meshes[shape], chunk_steps=S, block_walks=BW, window=W,
            negative=5, k_shared=K, sync_every=2, update_cap=CAP,
            neg_share_packs=NSP)
        got = fn(jnp.asarray(w_in), jnp.asarray(w_out), jnp.asarray(walks),
                 neg_table, key, *sched)
        name = f"dp_{shape[0]}x{shape[1]}"
        cases[name] = ("dp", dict(
            mesh=shape, w_in=w_in, w_out=w_out, walks=walks,
            eff=effs(k1, (S, geo.G, geo.PL)),
            negs=np.stack([negs(jax.random.fold_in(k2, d), (S, geo.G2, K))
                           for d in range(shape[0])])))
        want[name] = tuple(np.asarray(x) for x in got)

    # HS: the window draws folded by data rank
    points, codes, _ = build_huffman(np.bincount(
        walks[walks >= 0], minlength=V).astype(np.float64))
    w_tree = (rng.standard_normal((V - 1, D)) * 0.3).astype(np.float32)
    for shape in ((N, 1), (1, N)):
        geo = dp_geometry(NW, L, BW, shape[0], 1)
        fn = jhs.sharded_hs_chunk(meshes[shape], chunk_steps=S,
                                  block_walks=BW, window=W, update_cap=CAP,
                                  sync_every=2)
        got = fn(jnp.asarray(w_in), jnp.asarray(w_tree), jnp.asarray(walks),
                 jnp.asarray(points), jnp.asarray(codes), key, *sched)
        name = f"hs_{shape[0]}x{shape[1]}"
        eff = np.stack([effs(jax.random.fold_in(jax.random.fold_in(
            key, T0), d), (S, geo.G, geo.PL)) for d in range(shape[0])])
        cases[name] = ("hs", dict(mesh=shape, w_in=w_in, w_tree=w_tree,
                                  walks=walks, points=points, codes=codes,
                                  eff=eff))
        want[name] = tuple(np.asarray(x) for x in got)

    # LINE: each rank's batch from the key folded by its rank
    B, E = 64, 300
    edges = dict(
        edge_src=jnp.asarray(rng.integers(0, V, E).astype(np.int32)),
        edge_dst=jnp.asarray(rng.integers(0, V, E).astype(np.int32)),
        edge_accept=jnp.asarray(rng.random(E).astype(np.float32)),
        edge_alias=jnp.asarray(rng.integers(0, E, E).astype(np.int32)))
    emb = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    ctx = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    for order_first, k_shared in ((False, 0), (True, 20)):
        fn = jpl.sharded_line_chunk(
            meshes[(N, 1)], chunk_steps=S, batch_size=B, negative=5,
            order_first=order_first, k_shared=k_shared, update_cap=CAP,
            sync_every=2)
        jctx = jnp.zeros((1, D)) if order_first else jnp.asarray(ctx)
        got = fn(jnp.asarray(emb), jctx, *edges.values(), neg_table, key,
                 f32(0.025), i32(T0), f32(TOTAL))
        draws = [jline._line_bulk_samples(
            *edges.values(), neg_table, jax.random.fold_in(key, r),
            f32(0.025), i32(T0), f32(TOTAL), chunk_steps=S,
            batch_size=B // N, negative=5, k_shared=k_shared)
            for r in range(N)]
        name = f"line_first{int(order_first)}_k{k_shared}"
        cases[name] = ("line", dict(
            emb=emb, ctx=None if order_first else ctx, k_shared=k_shared,
            draws=[np.stack([np.array(d[i]) for d in draws])
                   for i in range(4)]))
        want[name] = tuple(np.asarray(x) for x in got)

    cases["line_model_axis"] = ("line_model_axis", dict(mesh=(1, N)))
    return cases, want, meshes


@pytest.fixture(scope="module")
def results():
    import jax
    from graphembedding_tpu.parallel.line import sharded_line_chunk

    cases, want, meshes = _jax_cases()
    with pytest.raises(ValueError, match="data axis only"):
        sharded_line_chunk(meshes[(1, N)], chunk_steps=4, batch_size=64,
                           negative=5, order_first=False)
    assert len(jax.devices()) >= N
    got = run_ranks(port_cases, N, cases)
    return want, got


def test_fetch_and_push_on_ragged_ownership(results):
    want, got = results
    rows_j, buf_j = want["fetch_push"]
    for r in range(N):
        rows, buf = got[r]["fetch_push"]
        np.testing.assert_array_equal(rows, rows_j[r])
        np.testing.assert_allclose(buf, buf_j[r * buf.shape[0]:(r + 1)
                                              * buf.shape[0]], rtol=1e-6)
    assert (rows_j == 0).all(axis=-1).any()  # pads come back as zeros


@pytest.mark.parametrize("prefetch", [0, 1])
def test_rowsharded_chunk_matches_jax(results, prefetch):
    want, got = results
    name = f"rowshard_prefetch{prefetch}"
    w_j, loss_j = want[name]
    w = rowshard_tables_to_numpy([got[r][name][0] for r in range(N)])
    np.testing.assert_allclose(w, w_j, rtol=1e-4, atol=1e-6)
    assert np.abs(w[:V, D:]).max() > 0.3  # the steps moved the table
    for r in range(N):
        np.testing.assert_allclose(got[r][name][1], loss_j, rtol=1e-4)
        np.testing.assert_array_equal(got[r][name][2], got[0][name][2])
    if prefetch:  # one step of staleness: not the synchronous update
        assert np.abs(w - np.concatenate(
            [got[r]["rowshard_prefetch0"][0] for r in range(N)])).max() > 0


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_dp_chunk_matches_jax(results, shape):
    want, got = results
    name = f"dp_{shape}"
    w_in_j, w_out_j, loss_j = want[name]
    parts = [got[r][name][0] for r in range(N)]
    if shape == "2x1":  # replicas agree after the final sync
        np.testing.assert_array_equal(parts[0], parts[1])
        w = parts[0]
        Dl = D
    else:  # column slices
        Dl = D // N
        w = np.concatenate([np.concatenate([p[:, :Dl] for p in parts], 1),
                            np.concatenate([p[:, Dl:] for p in parts], 1)],
                           1)
    np.testing.assert_allclose(w[:, :D], w_in_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(w[:, D:], w_out_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got[0][name][1], loss_j, rtol=1e-4)


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_hs_chunk_matches_jax(results, shape):
    want, got = results
    name = f"hs_{shape}"
    w_in_j, w_tree_j, loss_j = want[name]
    if shape == "2x1":
        w_in, w_tree = got[0][name][:2]
        np.testing.assert_array_equal(w_in, got[1][name][0])
    else:
        w_in, w_tree = (np.concatenate([got[r][name][i] for r in range(N)],
                                       1) for i in (0, 1))
    np.testing.assert_allclose(w_in, w_in_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w_tree, w_tree_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[0][name][2], loss_j, rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["line_first0_k0", "line_first1_k20"])
def test_line_chunk_matches_jax(results, name):
    want, got = results
    emb_j, ctx_j, loss_j = want[name]
    emb, ctx, loss = got[0][name]
    np.testing.assert_array_equal(emb, got[1][name][0])
    np.testing.assert_allclose(emb, emb_j, rtol=1e-5, atol=1e-6)
    if ctx is not None:
        np.testing.assert_allclose(ctx, ctx_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss, loss_j, rtol=1e-5, atol=1e-6)


def test_line_rejects_model_axis(results):
    _, got = results
    for r in range(N):
        assert "data axis only" in got[r]["line_model_axis"]
