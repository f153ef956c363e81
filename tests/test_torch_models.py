"""Port's datasets, classifier and DeepWalk against the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from graphembedding_tpu.data import datasets as jds
from graphembedding_tpu.eval.classify import Classifier as JaxClassifier
from graphembedding_tpu_torch import DeepWalk, Node2Vec
from graphembedding_tpu_torch.data import datasets as tds
from graphembedding_tpu_torch.eval.classify import Classifier, f1_scores

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's CPU training: with a thread per
    core in each of several test processes at once, the hard-SBM gates
    ran some 30x slower than alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("make", ["synthetic_wiki", "synthetic_wiki_hard"])
def test_synthetic_graphs_equal_jax(make):
    a, b = getattr(tds, make)(), getattr(jds, make)()
    for name in ("row_ptr", "col_idx", "edge_weight", "degree"):
        np.testing.assert_array_equal(getattr(a.graph, name),
                                      getattr(b.graph, name))
    assert a.labels == b.labels and a.name == b.name
    assert list(a.graph.vocab.idx2node) == list(b.graph.vocab.idx2node)


def test_load_wiki_is_the_synthetic_graph():
    ds = tds.load_dataset("wiki")
    assert (ds.graph.num_nodes, ds.graph.num_edges) == (2405, 16305)
    assert ds.graph.max_degree == 139
    # BlogCatalog loads its synthetic stand-in (tests/test_torch_utils.py
    # holds it against the JAX package's); unknown names raise as there
    bc = tds.load_dataset("blogcatalog")
    assert (bc.name, bc.graph.num_nodes) == ("blogcatalog-synthetic", 10312)
    assert len({y[0] for y in bc.Y}) == 39
    with pytest.raises(ValueError, match="unknown dataset"):
        tds.load_dataset("cora")


def test_classifier_matches_sklearn():
    """Same embeddings through both classifiers: the L-BFGS solutions
    differ only by solver tolerance, so micro-F1 agrees within 0.02."""
    rng = np.random.default_rng(0)
    n, k, dim = 600, 6, 16
    labels = rng.integers(0, k, n)
    centers = rng.standard_normal((k, dim))
    emb = centers[labels] * 0.6 + rng.standard_normal((n, dim))
    embeddings = {str(i): emb[i].astype(np.float32) for i in range(n)}
    X = [str(i) for i in range(n)]
    Y = [[str(labels[i])] for i in range(n)]
    ours = Classifier(embeddings).split_train_evaluate(X, Y, 0.8, seed=0)
    ref = JaxClassifier(embeddings).split_train_evaluate(X, Y, 0.8, seed=0)
    assert 0.5 < ref["micro"] < 0.95  # a discriminative band
    assert abs(ours["micro"] - ref["micro"]) <= 0.02, (ours, ref)
    assert abs(ours["macro"] - ref["macro"]) <= 0.02, (ours, ref)


def test_f1_scores_match_sklearn():
    from sklearn.metrics import accuracy_score, f1_score

    rng = np.random.default_rng(1)
    t = (rng.random((50, 5)) < 0.3).astype(int)
    p = (rng.random((50, 5)) < 0.3).astype(int)
    got = f1_scores(t, p)
    for avg in ("micro", "macro", "samples", "weighted"):
        assert got[avg] == pytest.approx(
            f1_score(t, p, average=avg, zero_division=0))
    assert got["acc"] == pytest.approx(accuracy_score(t, p))


def test_deepwalk_hard_sbm_gate():
    """The gate of tests/test_models.py::test_deepwalk_hard_sbm_gate on
    the port, over the three calibrated seeds
    (benchmarks/gate_calibration_r05.json): every seed >= 0.55, mean >=
    0.60."""
    ds = tds.synthetic_wiki_hard()
    scores = []
    for seed in (0, 1, 2):
        m = DeepWalk(ds.graph, walk_length=10, num_walks=20, seed=seed,
                     device="cpu")
        m.train(embed_size=64, window_size=5, iter=3)
        r = Classifier(m.get_embeddings()).split_train_evaluate(
            ds.X, ds.Y, 0.8, seed=0)
        scores.append(r["micro"])
    assert min(scores) >= 0.55, scores
    assert sum(scores) / len(scores) >= 0.60, scores


def test_unsupported_options_raise(tmp_path):
    ds = tds.synthetic_wiki(num_nodes=60, num_classes=3, seed=3)
    m = DeepWalk(ds.graph, walk_length=5, num_walks=2, device="cpu")
    # cap_mode= is ported for SGNS (tests/test_torch_large_v.py) and, as
    # in the JAX package, accepted and not passed on with hs=1
    # (tests/test_torch_hs_sparse.py); the block-preserving shuffle is not
    with pytest.raises(NotImplementedError):
        m.train(embed_size=8, iter=1, shuffle_mode="block")
    m.train(embed_size=8, iter=1, hs=1, cap_mode="sparse")
    # train(mesh=) is ported (tests/test_torch_parallel_models.py) and takes
    # a parallel.mesh.Mesh only
    for kw in ({"mesh": object()}, {"hs": 1, "mesh": object()}):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            m.train(embed_size=8, iter=1, **kw)
    # checkpoints and metrics are ported (tests/test_torch_checkpoint.py)
    from graphembedding_tpu_torch.utils.metrics import MetricsLogger

    for hs in (0, 1):
        with MetricsLogger(str(tmp_path / f"m{hs}.jsonl"), quiet=True) as ml:
            m.train(embed_size=8, iter=1, hs=hs, metrics=ml,
                    checkpoint_dir=str(tmp_path / f"c{hs}"),
                    checkpoint_every=1)
        lines = open(tmp_path / f"m{hs}.jsonl").read().splitlines()
        assert len(lines) * 64 == m.losses.shape[0] > 0
        assert os.listdir(tmp_path / f"c{hs}") == ["state.pt"]
    # trainer='dense' trains (tests/test_torch_dense.py); with hs it is
    # invalid, as in the JAX package
    with pytest.raises(ValueError):
        m.train(embed_size=8, iter=1, trainer="dense", hs=1)
    # the constructors' mesh= is ported (tests/test_torch_walks_models.py)
    # and takes a parallel.mesh.Mesh only
    for cls in (DeepWalk, Node2Vec):
        with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
            cls(ds.graph, mesh=object(), device="cpu")
    # walk_exchange= only matters with a mesh, as in the JAX package
    for exchange in (None, "a2a"):
        DeepWalk(ds.graph, walk_length=5, num_walks=2,
                 walk_exchange=exchange, device="cpu")
    # hs=1 trains hierarchical softmax: w_out is the [V - 1, D] tree
    n2v = Node2Vec(ds.graph, walk_length=5, num_walks=2, device="cpu")
    n2v.train(embed_size=8, iter=1, hs=1)
    assert tuple(n2v.w_out.shape) == (59, 8)
    assert n2v.losses.numel() > 0 and torch.isfinite(n2v.losses).all()


@pytest.mark.parametrize("model", ["DeepWalk", "Node2Vec", "LINE", "SDNE"])
def test_models_default_to_the_card(model):
    """Without device= a model runs on the CUDA card; where there is none
    it raises rather than run on the CPU. Validation errors come first
    (SDNE's constructor validates nothing, as in the JAX package)."""
    import graphembedding_tpu_torch as pkg

    ds = tds.synthetic_wiki(num_nodes=60, num_classes=3, seed=3)
    cls = getattr(pkg, model)
    bad = {"LINE": {"order": "third"}, "SDNE": None}.get(
        model, {"mesh": object()})
    if bad is not None:
        with pytest.raises((TypeError, ValueError)):
            cls(ds.graph, **bad)
    if torch.cuda.is_available():
        assert cls(ds.graph).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(ds.graph)
    assert cls(ds.graph, device="cpu").device.type == "cpu"


def test_port_imports_no_jax():
    code = ("import sys, graphembedding_tpu_torch, "
            "graphembedding_tpu_torch.train, graphembedding_tpu_torch.data, "
            "graphembedding_tpu_torch.interop, "
            "graphembedding_tpu_torch.models.line, "
            "graphembedding_tpu_torch.models.node2vec, "
            "graphembedding_tpu_torch.models.struc2vec, "
            "graphembedding_tpu_torch.train.hsoftmax, "
            "graphembedding_tpu_torch.models.sdne, "
            "graphembedding_tpu_torch.ops.spmm, "
            "graphembedding_tpu_torch.train.dense, "
            "graphembedding_tpu_torch.train.adam, "
            "graphembedding_tpu_torch.train.chunk_graph, "
            "graphembedding_tpu_torch.parity.reference, "
            "graphembedding_tpu_torch.native, "
            "graphembedding_tpu_torch.ops.walk, "
            "graphembedding_tpu_torch.benchmarks.dma_gather, "
            "graphembedding_tpu_torch.benchmarks.scatter_bench, "
            "graphembedding_tpu_torch.benchmarks.spmm_bench, "
            "graphembedding_tpu_torch.benchmarks.train_profile, "
            "graphembedding_tpu_torch.benchmarks.million, "
            "graphembedding_tpu_torch.benchmarks.table_scale, "
            "graphembedding_tpu_torch.benchmarks.pq_crossover, "
            "graphembedding_tpu_torch.utils, "
            "graphembedding_tpu_torch.utils.checkpoint, "
            "graphembedding_tpu_torch.utils.metrics, "
            "graphembedding_tpu_torch.utils.io, "
            "graphembedding_tpu_torch.utils.simquery, "
            "graphembedding_tpu_torch.utils.debug, "
            "graphembedding_tpu_torch.utils.profiling, "
            "graphembedding_tpu_torch.walker, "
            "graphembedding_tpu_torch.examples.common, "
            "graphembedding_tpu_torch.examples.deepwalk_wiki, "
            "graphembedding_tpu_torch.examples.node2vec_wiki, "
            "graphembedding_tpu_torch.examples.line_wiki, "
            "graphembedding_tpu_torch.examples.line_blogcatalog, "
            "graphembedding_tpu_torch.examples.sdne_wiki, "
            "graphembedding_tpu_torch.examples.struc2vec_flight, "
            "graphembedding_tpu_torch.examples.deepwalk_multihost, "
            "graphembedding_tpu_torch.parallel, "
            "graphembedding_tpu_torch.parallel.comm, "
            "graphembedding_tpu_torch.parallel.mesh, "
            "graphembedding_tpu_torch.parallel.launch, "
            "graphembedding_tpu_torch.parallel.rowshard, "
            "graphembedding_tpu_torch.parallel.sgns, "
            "graphembedding_tpu_torch.parallel.trainer, "
            "graphembedding_tpu_torch.parallel.hsoftmax, "
            "graphembedding_tpu_torch.parallel.line, "
            "graphembedding_tpu_torch.parallel.sdne, "
            "graphembedding_tpu_torch.parallel.walks; "
            "assert 'jax' not in sys.modules; "
            "assert 'graphembedding_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card; chip_smoke.py runs for real")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
