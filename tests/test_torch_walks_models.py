"""The walk models built with mesh= at 2 gloo ranks on the CPU.

`DeepWalk(G, mesh=m)` (the all-gather engine, and walk_exchange='a2a'),
`Node2Vec(G, mesh=m, p=0.5, q=2)` and `Struc2Vec(G, mesh=m)` walk over the
mesh, set `walk_overflow`, and train over the same mesh without being
given it; each must pass the gate of tests/test_parallel.py:820 (0.9 for
the walk models in dp mode, 0.5 for Struc2Vec with hs=1). The JAX package's
test trains on 20 walks a node over 8 devices; over 2 devices it scores
below its gates there (0.54-0.58 for dp on 20 walks, 0.958-1.0 on 40), so
these train on 40 walks a node, as tests/test_torch_parallel_models.py
does. `trainer='dense'` still refuses the model's mesh, as in the JAX
package.

One spawn of 2 ranks (one torch thread each) runs every case; jax is not
imported here.
"""

import tempfile

import pytest

from graphembedding_tpu_torch.parallel.launch import run_ranks

N = 2
GATES = {"deepwalk_dp": 0.9, "deepwalk_a2a": 0.9, "node2vec": 0.9,
         "struc2vec": 0.5}


def _f1(model, ds):
    from graphembedding_tpu_torch.eval.classify import Classifier

    return Classifier(model.get_embeddings()).split_train_evaluate(
        ds.X, ds.Y, 0.8)["micro"]


def _summary(m, ds):
    try:
        m.train(trainer="dense", hs=0)
        dense = None
    except ValueError as e:
        dense = str(e)
    return dict(f1=_f1(m, ds), overflow=m.walk_overflow,
                walks=tuple(m.walks.shape), dtype=str(m.walks.dtype),
                device=str(m.walks.device), has_mesh=m.mesh is not None,
                dense=dense)


def model_cases(info):
    from graphembedding_tpu_torch import DeepWalk, Node2Vec, Struc2Vec
    from graphembedding_tpu_torch.data.datasets import (
        synthetic_flight,
        synthetic_wiki,
    )
    from graphembedding_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh((N, 1), device="cpu")
    ds = synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8, seed=5)
    out = {}
    for name, cls, kw in (("deepwalk_dp", DeepWalk, {}),
                          ("deepwalk_a2a", DeepWalk,
                           {"walk_exchange": "a2a"}),
                          ("node2vec", Node2Vec, {"p": 0.5, "q": 2.0})):
        m = cls(ds.graph, walk_length=10, num_walks=40, mesh=mesh,
                device="cpu", **kw)
        m.train(embed_size=32, window_size=5, iter=3, block_walks=64,
                parallel_mode="dp")
        out[name] = _summary(m, ds)
        if name == "node2vec":
            out[name]["sampler"] = m.sampler
    fl = synthetic_flight(num_nodes=40, seed=2)
    with tempfile.TemporaryDirectory() as tmp:
        m = Struc2Vec(fl.graph, walk_length=8, num_walks=40,
                      temp_path=tmp + "/", mesh=mesh, device="cpu")
        m.train(embed_size=24, window_size=4, iter=4, hs=1)
    out["struc2vec"] = _summary(m, fl)
    return out


@pytest.fixture(scope="module")
def results():
    return run_ranks(model_cases, N, timeout_s=600)


@pytest.mark.parametrize("name", sorted(GATES))
def test_mesh_model_passes_its_gate(results, name):
    runs = [r[name] for r in results]
    assert runs[0]["f1"] >= GATES[name], runs[0]
    assert runs[1]["f1"] == runs[0]["f1"]  # the ranks' tables are equal


@pytest.mark.parametrize("name", sorted(GATES))
def test_mesh_model_walks_and_defaults(results, name):
    for run in (r[name] for r in results):
        assert run["overflow"] == 0 and run["has_mesh"]
        nw, V = (40, 40) if name == "struc2vec" else (40, 120)
        assert run["walks"] == (nw * V, 8 if name == "struc2vec" else 10)
        assert (run["dtype"], run["device"]) == ("torch.int32", "cpu")
        # train() defaulted to the constructor's mesh: the dense trainer
        # refuses it
        assert "mesh=" in run["dense"]
    if name == "node2vec":
        assert results[0][name]["sampler"] == "exact"
