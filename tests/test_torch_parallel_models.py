"""The port's models and trainers over a mesh of 2 gloo ranks on the CPU.

Against graphembedding_tpu: the block plan, per-rank packing and block
offsets of the mesh trainers (the JAX package's formulas,
parallel/trainer.py:73-100, rowshard.py:160-190, sgns.py:68-88,
train/hsoftmax.py:300-315), both SDNE mesh trainers (five Adam steps from
the JAX package's parameters, against its 2-device mesh run and the port's
single-device run: losses rtol 1e-5, parameters rtol 1e-5 / atol 5e-6, the
single-device SDNE parity test's tolerances) and the quality gates of
tests/test_parallel.py on the same graph.

The gates: rowshard >= 0.7 and dp >= 0.9 for DeepWalk, hs=1 >= 0.7, LINE
order 'second' with sync_every=16 >= 0.6, Struc2Vec >= 0.4. The JAX tests
train DeepWalk on 20 walks a node over 8 devices; over 2 devices the JAX
package scores 0.58-0.63 (rowshard) and 0.54-0.58 (dp) there, below both
gates, and 0.958-1.0 for both at 40 walks a node (seeds 0-2), so the
DeepWalk gates here train on 40 walks a node.

Also: a mid-run crash resumed bit for bit (torch.equal) in both modes, a
foreign checkpoint refused, SDNE's minibatch and a model axis refused over a
mesh, tiny corpora and ragged LINE batches refused, put_global's shards.

One spawn of 2 ranks (one torch thread each) runs every case
(`model_cases`); jax is imported inside functions only, as the ranks import
this module.
"""

import os

import numpy as np
import pytest
import torch

from graphembedding_tpu_torch.parallel.launch import run_ranks

N = 2


# ---- the port's side, in each spawned rank (no jax here) ---------------

def _f1(model, ds):
    from graphembedding_tpu_torch.eval.classify import Classifier

    return Classifier(model.get_embeddings()).split_train_evaluate(
        ds.X, ds.Y, 0.8)["micro"]


def _raises(fn, exc=Exception):
    try:
        fn()
    except exc as e:
        return f"{type(e).__name__}: {e}"
    return None


class _Crash(Exception):
    pass


class _CrashAfter:
    """A metrics logger that raises once a chunk past `at_step` ran."""

    def __init__(self, at_step):
        self.at_step = at_step

    def log(self, **kw):
        if kw["step"] > self.at_step:
            raise _Crash()


def _gates(mesh):
    from graphembedding_tpu_torch import LINE, DeepWalk, Struc2Vec
    from graphembedding_tpu_torch.data.datasets import (
        synthetic_flight,
        synthetic_wiki,
    )

    ds = synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8, seed=5)
    out = {}
    for mode in ("rowshard", "dp"):
        m = DeepWalk(ds.graph, walk_length=10, num_walks=40, seed=0,
                     device="cpu")
        m.train(embed_size=32, window_size=5, iter=3, block_walks=64,
                mesh=mesh, parallel_mode=mode)
        out[mode] = _f1(m, ds)
    m = DeepWalk(ds.graph, walk_length=10, num_walks=20, seed=0,
                 device="cpu")
    m.train(embed_size=32, window_size=5, iter=3, hs=1, mesh=mesh)
    out["hs"] = _f1(m, ds)
    m = LINE(ds.graph, embedding_size=32, order="second", device="cpu")
    m.train(batch_size=256, epochs=60, mesh=mesh, sync_every=16)
    out["line"] = _f1(m, ds)
    fl = synthetic_flight(num_nodes=60, seed=1)
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        m = Struc2Vec(fl.graph, walk_length=8, num_walks=12,
                      temp_path=tmp + "/", seed=0, device="cpu")
        m.train(embed_size=24, window_size=3, iter=2, mesh=mesh)
    out["struc2vec"] = _f1(m, fl)
    out["struc2vec_finite"] = bool(torch.isfinite(m.losses).all())
    return out


def _checkpoints(mesh, tmp):
    from graphembedding_tpu_torch.parallel import DistributedSkipGramTrainer
    from graphembedding_tpu_torch.train.skipgram import SkipGramConfig
    from graphembedding_tpu_torch.utils.checkpoint import save_state

    rng = np.random.default_rng(0)
    walks = torch.from_numpy(rng.integers(0, 30, (128, 8)).astype(np.int32))
    cfg = SkipGramConfig(embed_size=8, epochs=2, chunk_steps=4,
                         block_walks=32)
    out = {}
    for mode in ("rowshard", "dp"):
        tr = DistributedSkipGramTrainer(mesh, cfg, mode=mode)
        ck = f"{tmp}/{mode}_ck"
        w_in, w_out, losses = tr.fit(walks, 30, checkpoint_dir=ck,
                                     checkpoint_every=1)
        plain = DistributedSkipGramTrainer(mesh, cfg, mode=mode).fit(walks,
                                                                     30)
        again = tr.fit(walks, 30, checkpoint_dir=ck)
        crashed = DistributedSkipGramTrainer(mesh, cfg, mode=mode)
        ck2 = f"{tmp}/{mode}_ck2"
        cut = _raises(lambda: crashed.fit(
            walks, 30, checkpoint_dir=ck2, checkpoint_every=1,
            metrics=_CrashAfter(cfg.chunk_steps)), _Crash)
        resumed = crashed.fit(walks, 30, checkpoint_dir=ck2)
        out[mode] = dict(
            steps=losses.shape[0], chunk=cfg.chunk_steps, cut=cut,
            files=sorted(os.listdir(ck)),
            plain_equal=all(torch.equal(a, b) for a, b in
                            zip((w_in, w_out, losses), plain)),
            again_steps=again[2].shape[0],
            again_equal=torch.equal(again[0], w_in),
            resumed_steps=resumed[2].shape[0],
            resumed_equal=(torch.equal(resumed[0], w_in)
                           and torch.equal(resumed[1], w_out)),
            finite=bool(torch.isfinite(w_in).all()))
    # a dp checkpoint is foreign to rowshard; so is a single-device one
    out["dp_into_rowshard"] = _raises(lambda: DistributedSkipGramTrainer(
        mesh, cfg, mode="rowshard").fit(walks, 30,
                                        checkpoint_dir=f"{tmp}/dp_ck"))
    if mesh.rank == 0:
        save_state(f"{tmp}/single", {"w_in": torch.zeros(4, 4),
                                     "w_out": torch.zeros(4, 4),
                                     "step": 4})
    from graphembedding_tpu_torch.parallel import comm

    comm.all_reduce(torch.zeros(1), None)  # rank 0 has written it
    out["single_into_rowshard"] = _raises(lambda: DistributedSkipGramTrainer(
        mesh, cfg, mode="rowshard").fit(walks, 30,
                                        checkpoint_dir=f"{tmp}/single"))
    return out


def _sdne(mesh, params):
    from graphembedding_tpu_torch import SDNE
    from graphembedding_tpu_torch.data.datasets import synthetic_wiki

    g = synthetic_wiki(num_nodes=75, num_classes=3, avg_degree=5,
                       seed=11).graph
    consts = dict(alpha=1e-4, beta=5.0, nu1=1e-5, nu2=1e-4)
    out = {}
    for kind in ("dense", "sparse"):
        for on_mesh in (True, False):
            m = SDNE(g, hidden_size=[16, 8], device="cpu", **consts)
            m.net.load_state_dict(params)
            kw = dict(mesh=mesh) if on_mesh else {}
            if kind == "dense":
                m.train(batch_size=100, epochs=5, **kw)
            else:
                m.train_sparse(epochs=5, row_chunk=16, **kw)
            out[kind, on_mesh] = (m.losses.numpy(), {
                k: v.detach().numpy() for k, v in m.net.state_dict().items()})
            if on_mesh:
                out[kind, "built_dense"] = m._A is not None
    m = SDNE(g, hidden_size=[16, 8], device="cpu")
    out["minibatch"] = _raises(lambda: m.train(batch_size=10, epochs=1,
                                               mesh=mesh))
    return out


def _refusals(mesh, mesh12):
    from graphembedding_tpu_torch import LINE, SDNE
    from graphembedding_tpu_torch.data.datasets import synthetic_wiki
    from graphembedding_tpu_torch.parallel import (
        DistributedSkipGramTrainer,
        put_global,
    )
    from graphembedding_tpu_torch.train.hsoftmax import HSTrainer

    ds = synthetic_wiki(num_nodes=40, num_classes=2, seed=1)
    tiny = torch.zeros((N - 1, 5), dtype=torch.int32)
    r = mesh.rank
    x = torch.arange(12.0).reshape(3, 4) + 100 * r  # rank 1's differs
    return dict(
        tiny_sgns=_raises(lambda: DistributedSkipGramTrainer(mesh).fit(
            tiny, 10)),
        tiny_hs=_raises(lambda: HSTrainer(mesh=mesh).fit(tiny, 10)),
        line_ragged=_raises(lambda: LINE(ds.graph, device="cpu").train(
            batch_size=63, mesh=mesh)),
        sdne_model_axis=_raises(lambda: SDNE(
            ds.graph, hidden_size=[4, 2], device="cpu").train(
                batch_size=100, mesh=mesh12)),
        put_rep=put_global(x, mesh).numpy(),
        put_rows=put_global(torch.arange(8.0).reshape(4, 2), mesh,
                            ("data", None)).numpy(),
        put_cols=put_global(x[:, :2] * 0 + torch.arange(2.0), mesh12,
                            (None, "model")).numpy(),
        put_shape=_raises(lambda: put_global(torch.zeros(2 + r), mesh)))


def model_cases(info, tmp, sdne_params):
    from graphembedding_tpu_torch.parallel import make_mesh

    mesh = make_mesh((N, 1), device="cpu")
    mesh12 = make_mesh((1, N), device="cpu")
    return dict(gates=_gates(mesh), checkpoints=_checkpoints(mesh, tmp),
                sdne=_sdne(mesh, sdne_params),
                refusals=_refusals(mesh, mesh12))


# ---- the JAX side, and the checks ---------------------------------------

@pytest.fixture(scope="module")
def results(tmp_path_factory):
    import jax

    from graphembedding_tpu.data.datasets import synthetic_wiki as jwiki
    from graphembedding_tpu.models import SDNE as JSDNE
    from graphembedding_tpu.parallel.mesh import make_mesh
    from graphembedding_tpu_torch.interop import sdne_params_from_jax

    g = jwiki(num_nodes=75, num_classes=3, avg_degree=5, seed=11).graph
    mesh = make_mesh((N, 1), devices=jax.devices()[:N])
    consts = dict(alpha=1e-4, beta=5.0, nu1=1e-5, nu2=1e-4)
    params = sdne_params_from_jax(
        JSDNE(g, hidden_size=[16, 8], seed=0, **consts).params)
    jax_sdne = {}
    for kind in ("dense", "sparse"):
        jm = JSDNE(g, hidden_size=[16, 8], seed=0, **consts)
        if kind == "dense":
            jm.train(batch_size=100, epochs=5, mesh=mesh)
        else:
            jm.train_sparse(epochs=5, row_chunk=16, mesh=mesh)
        jax_sdne[kind] = (np.asarray(jm.losses), sdne_params_from_jax(
            jm.params))
    got = run_ranks(model_cases, N, str(tmp_path_factory.mktemp("ranks")),
                    params)
    return got, jax_sdne


@pytest.mark.parametrize("NW,L,V,block_walks,n", [
    (2400, 10, 120, 64, 2), (4800, 10, 120, 64, 2), (128, 8, 30, 32, 2),
    (97, 7, 50, 4032, 2), (192400, 10, 2405, 4032, 2), (5, 5, 10, 4032, 4),
    (1000, 13, 300, 100, 3)])
def test_block_offsets_match_jax_formula(NW, L, V, block_walks, n):
    """The mesh trainers' block, packing and offsets against the JAX
    trainer's and chunk bodies' arithmetic."""
    from graphembedding_tpu.train.skipgram import SkipGramConfig as JCfg
    from graphembedding_tpu.train.skipgram import block_upscale as j_up
    from graphembedding_tpu_torch.parallel.rowshard import (
        block_offsets,
        rank_geometry,
    )
    from graphembedding_tpu_torch.parallel.sgns import (
        dp_geometry,
        dp_offsets,
    )
    from graphembedding_tpu_torch.parallel.trainer import (
        mesh_block_walks,
        mesh_steps_per_epoch,
    )
    from graphembedding_tpu_torch.train.hsoftmax import HSTrainer
    from graphembedding_tpu_torch.train.skipgram import SkipGramConfig

    cfg = SkipGramConfig(block_walks=block_walks)
    # parallel/trainer.py:73-100
    bw = min(j_up(NW, V, JCfg(block_walks=block_walks)), max(NW // 4, n),
             (NW // n) * n)
    assert mesh_block_walks(NW, V, cfg, n) == bw
    pk = max(min(max(128 // L, 1), max(bw // n, 1)), 1)
    bw_used = max((max(bw // n, 1) // pk) * pk, pk) * n
    assert mesh_steps_per_epoch(NW, L, bw, n) == max(NW // bw_used, 1)
    t0, S = 61, 70
    steps = t0 + np.arange(S)
    for nsp in (1, 4):
        # rowshard.py:160-190
        bw_local = max(min(bw, NW) // n, 1)
        Pk = max(min(max(128 // L, 1), bw_local), 1)
        G = bw_local // Pk
        used = G * Pk
        n_blocks = max(NW // (n * used), 1)
        sp = nsp
        while G % sp:
            sp -= 1
        geo = rank_geometry(NW, L, bw, n, nsp)
        assert (geo.G, geo.PL, geo.Bw, geo.n_blocks, geo.nsp, geo.G2) == (
            G, Pk * L, used, n_blocks, sp, G // sp)
        for di in range(n):
            offs = (steps % n_blocks) * n * used + di * used
            np.testing.assert_array_equal(
                block_offsets(t0, S, geo, n, di), offs)
            assert offs.max() + used <= NW  # every slice inside the corpus
        # sgns.py:63-88 (dp)
        bwl = bw // n
        Pk = max(min(max(128 // L, 1), bwl), 1)
        G = bwl // Pk
        geo = dp_geometry(NW, L, bw, n, nsp)
        assert (geo.G, geo.Bw, geo.n_blocks) == (G, G * Pk, NW // bw)
        for di in range(n):
            np.testing.assert_array_equal(
                dp_offsets(t0, S, geo, bw, n, di),
                (steps % (NW // bw)) * bw + di * bwl)
    # train/hsoftmax.py:300-315
    hs = HSTrainer(block_walks=block_walks)
    per = max(min(block_walks, max(NW // 4, n)) // n, 1)
    per = min(per, NW // n)
    pk = max(min(max(128 // L, 1), per), 1)
    assert hs._mesh_block_walks(NW, L, n) == max((per // pk) * pk, pk) * n


@pytest.mark.parametrize("name,gate", [
    ("rowshard", 0.7), ("dp", 0.9), ("hs", 0.7), ("line", 0.6),
    ("struc2vec", 0.4)])
def test_quality_gate_over_mesh(results, name, gate):
    got, _ = results
    for r in range(N):  # every rank holds the same tables
        assert got[r]["gates"][name] == got[0]["gates"][name]
    assert got[0]["gates"][name] >= gate, got[0]["gates"]
    assert got[0]["gates"]["struc2vec_finite"]


@pytest.mark.parametrize("mode", ["rowshard", "dp"])
def test_checkpoint_resume_bit_identical(results, mode):
    got, _ = results
    for r in range(N):
        c = got[r]["checkpoints"][mode]
        assert c["finite"] and c["files"] == ["rank0.pt", "rank1.pt"]
        assert c["plain_equal"]  # checkpoints change nothing
        assert c["again_steps"] == 0 and c["again_equal"]
        assert c["cut"] is not None  # the crash happened
        assert c["resumed_steps"] == c["steps"] - c["chunk"]
        assert c["resumed_equal"], c


def test_foreign_checkpoint_refused(results):
    got, _ = results
    for r in range(N):
        c = got[r]["checkpoints"]
        assert "lacks keys" in c["dp_into_rowshard"]
        assert "lacks keys" in c["single_into_rowshard"]


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_sdne_mesh_matches_jax_and_single_device(results, kind):
    got, jax_sdne = results
    j_losses, j_params = jax_sdne[kind]
    losses, params = got[0]["sdne"][kind, True]
    s_losses, s_params = got[0]["sdne"][kind, False]
    np.testing.assert_allclose(losses, j_losses, rtol=1e-5)
    np.testing.assert_allclose(losses, s_losses, rtol=1e-5)
    for k, v in params.items():
        np.testing.assert_allclose(v, j_params[k].numpy(), rtol=1e-5,
                                   atol=5e-6, err_msg=k)
        np.testing.assert_allclose(v, s_params[k], rtol=1e-5, atol=5e-6,
                                   err_msg=k)
        np.testing.assert_array_equal(v, got[1]["sdne"][kind, True][1][k])
    if kind == "sparse":
        assert not got[0]["sdne"][kind, "built_dense"]


def test_sdne_mesh_rejects_minibatch(results):
    got, _ = results
    assert "NotImplementedError" in got[0]["sdne"]["minibatch"]
    assert "full-batch" in got[0]["sdne"]["minibatch"]


def test_mesh_refusals_and_put_global(results):
    got, _ = results
    for r in range(N):
        f = got[r]["refusals"]
        assert "data axis" in f["tiny_sgns"] and "data axis" in f["tiny_hs"]
        assert "divide evenly" in f["line_ragged"]
        assert "data axis only" in f["sdne_model_axis"]
        assert "different shapes" in f["put_shape"]
        np.testing.assert_array_equal(
            f["put_rep"], np.arange(12.0).reshape(3, 4))  # rank 0's
        np.testing.assert_array_equal(
            f["put_rows"], np.arange(8.0).reshape(4, 2)[2 * r:2 * r + 2])
        np.testing.assert_array_equal(f["put_cols"], np.full((3, 1), r))
