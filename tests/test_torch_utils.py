"""Port's utility surface against graphembedding_tpu: embedding I/O,
similarity queries, validation, tracing, the walker classes, the
BlogCatalog loader and the example entry points."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import graphembedding_tpu.utils as jutils
from graphembedding_tpu.data import datasets as jds
from graphembedding_tpu.graph import Graph as JGraph
from graphembedding_tpu.utils import debug as jdebug
from graphembedding_tpu.utils import io as jio
from graphembedding_tpu.utils import simquery as jsim
from graphembedding_tpu_torch import BiasedWalker, RandomWalker, Struc2Vec
from graphembedding_tpu_torch import utils as tutils
from graphembedding_tpu_torch.data import datasets as tds
from graphembedding_tpu_torch.graph import Graph as TGraph
from graphembedding_tpu_torch.train import hsoftmax as ths
from graphembedding_tpu_torch.train import skipgram as tsg
from graphembedding_tpu_torch.utils import debug as tdebug
from graphembedding_tpu_torch.utils import io as tio
from graphembedding_tpu_torch.utils import simquery as tsim
from graphembedding_tpu_torch.utils.metrics import MetricsLogger
from graphembedding_tpu_torch.utils.profiling import trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def embeddings(V=300, D=16, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, D)).astype(np.float32)
    return {f"n{i}": table[i] for i in range(V)}


def test_utils_export_the_jax_names():
    assert set(jutils.__all__) <= set(tutils.__all__)
    assert set(tutils.__all__) - set(jutils.__all__) == {"IdentityVocab"}
    for name in ("partition_num", "partition_dict", "partition_list"):
        fn, jfn = getattr(tutils, name), getattr(jutils, name)
        arg = 10 if name == "partition_num" else (
            {i: [i] for i in range(10)} if name == "partition_dict"
            else list(range(10)))
        assert fn(arg, 3) == jfn(arg, 3)


def test_word2vec_bytes_equal_jax_and_files_cross_read(tmp_path):
    emb = embeddings(V=40, D=8)
    ours, theirs = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    tio.save_word2vec_format(emb, ours)
    jio.save_word2vec_format(emb, theirs)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for got in (tio.load_word2vec_format(theirs),
                jio.load_word2vec_format(ours)):
        assert list(got) == list(emb)
        assert all(np.array_equal(got[k], emb[k]) for k in emb)
    tio.save_npz(emb, str(tmp_path / "t.npz"))
    jio.save_npz(emb, str(tmp_path / "j.npz"))
    for got in (tio.load_npz(str(tmp_path / "j")),
                jio.load_npz(str(tmp_path / "t.npz"))):
        assert list(got) == list(emb)
        assert all(np.array_equal(got[k], emb[k]) for k in emb)


def test_word2vec_rejects_what_jax_rejects(tmp_path):
    for bad in ({"a b": np.ones(2)}, {"a": np.ones(2), "b": np.ones(3)},
                {}):
        for mod in (tio, jio):
            p = str(tmp_path / f"{mod.__name__}.txt")
            with pytest.raises(ValueError):
                mod.save_word2vec_format(bad, p)
            assert not os.path.exists(p)


@pytest.mark.parametrize("form", ["dict", "pair"])
def test_most_similar_numpy_path_equals_jax(form):
    emb = embeddings()
    arg = emb if form == "dict" else (list(emb), np.stack(list(emb.values())))
    for kw in ({"node": "n7"}, {"vector": emb["n3"] * 2.0},
               {"node": "n0", "topn": 299}):
        assert tsim.most_similar(arg, **kw) == jsim.most_similar(arg, **kw)
    assert tsim.similarity(arg, "n1", "n2") == jsim.similarity(
        arg, "n1", "n2")
    for mod in (tsim, jsim):
        with pytest.raises(KeyError):
            mod.most_similar(arg, node="nope")
        with pytest.raises(ValueError):
            mod.most_similar(arg)


def same_ranking(got, want, atol=1e-5):
    """The same names and scores within atol, apart from the order of
    scores that tie within atol."""
    assert len(got) == len(want)
    for (gn, gs), (wn, ws) in zip(got, want):
        assert abs(gs - ws) <= atol
    g, w = dict(got), dict(want)
    for name in set(g) ^ set(w):  # a tie across the cut
        score = g.get(name, w.get(name))
        assert abs(score - want[-1][1]) <= atol


def test_most_similar_device_path_equals_numpy(monkeypatch):
    """The device path (torch.matmul + torch.topk), here on the CPU with
    the threshold lowered, against the JAX package's numpy path; the pair
    form's table is uploaded once."""
    emb = embeddings(V=500)
    names, table = list(emb), np.stack(list(emb.values()))
    want = [jsim.most_similar((names, table), node=n, topn=10)
            for n in ("n0", "n42")]
    want.append(jsim.most_similar(emb, vector=table[5] + 0.1, topn=10))
    monkeypatch.setattr(tsim, "_DEVICE_MIN_ROWS", 64)
    got = [tsim.most_similar((names, table), node=n, topn=10, device="cpu")
           for n in ("n0", "n42")]
    cached = tsim._device_tables["last"][2]
    got.append(tsim.most_similar(emb, vector=table[5] + 0.1, topn=10,
                                 device="cpu"))
    for g, w in zip(got, want):
        same_ranking(g, w)
    tsim.most_similar((names, table), node="n1", device="cpu")
    assert tsim._device_tables["last"][2] is cached
    if torch.cuda.is_available():
        same_ranking(tsim.most_similar((names, table), node="n0",
                                       topn=10), want[0])
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tsim.most_similar((names, table), node="n0")
    del table  # the cached copy goes with the host table
    assert "last" not in tsim._device_tables


def ring(mod, n=12):
    src = np.arange(n)
    return mod.Graph(src, (src + 1) % n, directed=False)


GRAPH_FAULTS = {
    "col_idx out of range": ("col_idx", 3, lambda g: g.num_nodes + 7),
    "row_ptr decreasing": ("row_ptr", 2, lambda g: g.row_ptr[1] - 1),
    "nan weight": ("edge_weight", 0, lambda g: np.nan),
    "negative weight": ("edge_weight", 1, lambda g: -1.0),
}


@pytest.mark.parametrize("fault", list(GRAPH_FAULTS))
def test_validate_graph_raises_as_jax(fault):
    name, i, value = GRAPH_FAULTS[fault]
    messages = []
    for mod, validate in ((sys.modules[TGraph.__module__],
                           tdebug.validate_graph),
                          (sys.modules[JGraph.__module__],
                           jdebug.validate_graph)):
        g = ring(mod)
        validate(g)
        arr = getattr(g, name).copy()
        arr[i] = value(g)
        setattr(g, name, arr)
        with pytest.raises(ValueError) as e:
            validate(g)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


WALK_FAULTS = {
    "token too large": np.array([[0, 9, 2, -1]], np.int32),
    "pad not trailing": np.array([[0, -1, 2, 3]], np.int32),
    "token below -1": np.array([[0, -2, 2, 3]], np.int32),
    "not 2-d": np.array([0, 1, 2], np.int32),
    "not integer": np.array([[0.0, 1.0]]),
}


@pytest.mark.parametrize("fault", list(WALK_FAULTS))
def test_validate_walks_raises_as_jax(fault):
    walks = WALK_FAULTS[fault]
    messages = []
    for validate in (tdebug.validate_walks, jdebug.validate_walks):
        validate(np.array([[0, 1, 2, -1], [3, 2, 1, 0]], np.int32), 4)
        with pytest.raises(ValueError) as e:
            validate(walks, 4)
        messages.append(str(e.value))
    assert messages[0] == messages[1]


def test_validation_hooks_follow_the_environment(monkeypatch):
    """GE_TPU_VALIDATE turns on the checks in Graph construction and in
    both trainers' fits; unset, a bad corpus is not inspected."""
    bad = torch.tensor([[0, 1, 2, 3]] * 8, dtype=torch.int32)
    monkeypatch.setenv("GE_TPU_VALIDATE", "1")
    for mod in (sys.modules[TGraph.__module__],
                sys.modules[JGraph.__module__]):
        with pytest.raises(ValueError, match="NaN"):
            mod.Graph(np.array([0, 1]), np.array([1, 2]),
                      np.array([1.0, np.nan], np.float32))
    fits = (lambda: tsg.SkipGramTrainer(embed_size=4, epochs=1).fit(bad, 3),
            lambda: ths.HSTrainer(embed_size=4, epochs=1).fit(bad, 3))
    for fit in fits:
        with pytest.raises(ValueError, match="outside"):
            fit()
    monkeypatch.delenv("GE_TPU_VALIDATE")
    TGraph(np.array([0, 1]), np.array([1, 2]),
           np.array([1.0, np.nan], np.float32))


def test_checked_and_debug_guard():
    def fine(x):
        return x * 2, {"n": torch.arange(3)}

    out, extra = tdebug.checked(fine)(torch.ones(2))
    assert torch.equal(out, torch.full((2,), 2.0))
    with pytest.raises(FloatingPointError, match="NaN"):
        tdebug.checked(lambda x: (x, x / 0 * 0))(torch.ones(2))
    with pytest.raises(FloatingPointError, match="Inf"):
        tdebug.checked(lambda x: [x / 0])(torch.ones(2))
    tdebug.checked(lambda x: x / 0, div=False)(torch.ones(2))
    with pytest.raises(IndexError):  # eager indexing raises by itself
        tdebug.checked(lambda t: t[torch.tensor([5])])(torch.ones(2))

    prev = torch.is_anomaly_enabled()
    with tdebug.debug_guard(nans=True, disable_jit=True):
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan|NaN"):
            torch.sqrt(x).sum().backward()
    assert torch.is_anomaly_enabled() == prev


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert prof.key_averages()
    events = json.load(open(tmp_path / "tr" / "trace.json"))
    assert events["traceEvents"]


def test_metrics_logger_writes_jsonl(tmp_path, capsys):
    p = str(tmp_path / "m.jsonl")
    with MetricsLogger(p) as m:
        m.log(kind="x", loss=1.5)
    assert json.loads(capsys.readouterr().out)["loss"] == 1.5
    rec = json.loads(open(p).read())
    assert rec["kind"] == "x" and "t" in rec


def test_synthetic_blogcatalog_equals_jax():
    a, b = tds.synthetic_blogcatalog(), jds.synthetic_blogcatalog()
    for name in ("row_ptr", "col_idx", "edge_weight", "degree"):
        np.testing.assert_array_equal(getattr(a.graph, name),
                                      getattr(b.graph, name))
    assert a.labels == b.labels and a.name == b.name
    assert (a.graph.num_nodes, a.graph.directed) == (10312, True)
    # below SMALL_V_ROWS: LINE's scatters stay on K4
    from graphembedding_tpu_torch.ops.rows import SMALL_V_ROWS

    assert a.graph.num_nodes <= SMALL_V_ROWS


def hops_are_edges(sentences, graph):
    idx = graph.vocab.node2idx
    edges = set(zip(*[a.tolist() for a in graph.edges()[:2]]))
    return all((idx[u], idx[v]) in edges
               for s in sentences for u, v in zip(s, s[1:]))


@pytest.mark.parametrize("pq", [(1.0, 1.0), (0.5, 2.0)])
def test_random_walker_sentences_as_jax(pq):
    import graphembedding_tpu as ge

    p, q = pq
    ds = tds.synthetic_wiki(num_nodes=50, num_classes=2, avg_degree=5,
                            seed=12)
    jd = jds.synthetic_wiki(num_nodes=50, num_classes=2, avg_degree=5,
                            seed=12)
    w = RandomWalker(ds.graph, p=p, q=q, seed=7, device="cpu")
    assert w.preprocess_transition_probs() is w
    got = w.simulate_walks(num_walks=2, walk_length=6)
    want = ge.RandomWalker(jd.graph, p=p, q=q, seed=7).simulate_walks(
        num_walks=2, walk_length=6)
    assert len(got) == len(want) == 100
    assert all(isinstance(s, list) and 1 <= len(s) <= 6 for s in got)
    assert [s[0] for s in got] == [s[0] for s in want]  # node i starts
    assert all(tok in ds.graph.vocab.node2idx for s in got for tok in s)
    assert hops_are_edges(got, ds.graph)
    # seed= reproduces; the default stream moves on call to call
    assert w.simulate_walks(2, 6, seed=3) == w.simulate_walks(2, 6, seed=3)
    assert w.simulate_walks(2, 6, seed=3) != w.simulate_walks(2, 6, seed=4)
    again = RandomWalker(ds.graph, p=p, q=q, seed=7, device="cpu")
    assert again.simulate_walks(2, 6) == got
    assert w.simulate_walks(2, 6) != got


def test_biased_walker_sentences_as_jax(tmp_path):
    import graphembedding_tpu as ge

    ds = tds.synthetic_wiki(num_nodes=24, num_classes=2, avg_degree=4,
                            seed=15)
    jd = jds.synthetic_wiki(num_nodes=24, num_classes=2, avg_degree=4,
                            seed=15)
    tp, jp = str(tmp_path / "t") + "/", str(tmp_path / "j") + "/"
    model = Struc2Vec(ds.graph, walk_length=4, num_walks=1, temp_path=tp,
                      device="cpu")
    ge.Struc2Vec(jd.graph, walk_length=4, num_walks=1, temp_path=jp)
    idx2node = list(ds.graph.vocab.idx2node)
    bw = BiasedWalker(idx2node, tp, device="cpu")
    got = bw.simulate_walks(num_walks=2, walk_length=5)
    want = ge.BiasedWalker(idx2node, jp).simulate_walks(num_walks=2,
                                                        walk_length=5)
    assert [len(s) for s in got] == [len(s) for s in want] == [5] * 48
    assert [s[0] for s in got] == [s[0] for s in want]
    # every hop an edge of a layer of the context graph, or a stay
    ly = model.layers
    ok = set()
    for k in range(ly["row_ptr"].shape[0]):
        rp, ci = ly["row_ptr"][k].tolist(), ly["col_idx"][k].tolist()
        ok |= {(u, ci[e]) for u in range(24) for e in range(rp[u],
                                                            rp[u + 1])}
    idx = ds.graph.vocab.node2idx
    assert all((idx[u], idx[v]) in ok or u == v
               for s in got for u, v in zip(s, s[1:]))
    assert bw.simulate_walks(2, 5, seed=3) == bw.simulate_walks(2, 5, seed=3)
    assert bw.simulate_walks(2, 5) != bw.simulate_walks(2, 5)
    by_layers = BiasedWalker(idx2node, str(tmp_path / "none"),
                             layers={k: v.numpy() for k, v in ly.items()},
                             device="cpu")
    assert by_layers.simulate_walks(2, 5, seed=3) == bw.simulate_walks(
        2, 5, seed=3)
    with pytest.raises(FileNotFoundError):
        BiasedWalker(idx2node, str(tmp_path / "none"),
                     device="cpu").simulate_walks(1, 3)


EXAMPLES = ["deepwalk_wiki", "node2vec_wiki", "line_wiki",
            "line_blogcatalog", "sdne_wiki", "struc2vec_flight"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_help_runs(name):
    out = subprocess.run(
        [sys.executable, "-m", f"graphembedding_tpu_torch.examples.{name}",
         "--help"], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    for flag in ("--dataset", "--plot", "--json", "--device", "--trainer",
                 "--mesh"):
        assert flag in out.stdout
    assert ("--order" in out.stdout) == (name == "line_blogcatalog")


def test_example_runs_on_the_cpu(capsys):
    """The DeepWalk example end to end on the CPU on flight-brazil's 131
    nodes, its JSON line included."""
    from graphembedding_tpu_torch.examples import deepwalk_wiki

    model, res, train_s = deepwalk_wiki.main(
        ["--device", "cpu", "--dataset", "flight-brazil", "--embed-size",
         "16", "--json"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["model"], line["dataset"], line["device"]) == (
        "DeepWalk", "flight-synthetic", "cpu")
    assert line["micro"] == round(res["micro"], 4) and 0 < res["micro"] <= 1
    assert model.w_in.shape == (131, 16) and train_s > 0
