"""The port's spans and counters (`utils/profiling.py`).

On the CPU: the span tree of a small DeepWalk hs=1 fit and a small
Node2Vec SGNS fit (one `walk` and one `train` a model, with its fit id;
the tables, the Huffman build on hs=1 only, one `train.prepare` an epoch,
one `chunk` a chunk), the step and block counters against the fit's
geometry, a fit with recording off (nothing kept, the same tables), the
chunk-graph cache's counters and spans through the stand-in capture of
`tests/test_torch_chunk_graph.py`, the innermost span of a time, and the
program's spans in `trace`'s Chrome trace. On a card (skipped without
one): a span around a kernel launch holds the launch's runtime call in a
torch.profiler trace, and a fit synchronizes as often with recording on
as off.
"""

import collections
import contextlib
import json
import warnings

import pytest
import torch
from test_torch_chunk_graph import StandInCapture

from graphembedding_tpu_torch import DeepWalk, Node2Vec
from graphembedding_tpu_torch.data import datasets as tds
from graphembedding_tpu_torch.train import chunk_graph as cg
from graphembedding_tpu_torch.train.skipgram import (
    SkipGramConfig,
    block_geometry,
    fit_block_walks,
    plan_block_walks,
)
from graphembedding_tpu_torch.utils import profiling
from graphembedding_tpu_torch.utils.profiling import (
    count,
    record,
    span,
    trace,
)

# a corpus of 40 nodes x 4 walks of 6: 160 walks, one chunk of 64 steps
# an epoch for both trainers
NODES, WALKS, LENGTH, EPOCHS = 40, 4, 6, 2


@pytest.fixture
def graph():
    return tds.synthetic_wiki(num_nodes=NODES, num_classes=2, seed=3).graph


def deepwalk_hs(graph, seed=1):
    m = DeepWalk(graph, walk_length=LENGTH, num_walks=WALKS, seed=seed,
                 device="cpu")
    return m.train(embed_size=8, window_size=3, iter=EPOCHS, hs=1)


def node2vec_sgns(graph, seed=1):
    m = Node2Vec(graph, walk_length=LENGTH, num_walks=WALKS, p=0.5, q=2.0,
                 seed=seed, device="cpu")
    return m.train(embed_size=8, window_size=3, iter=EPOCHS, negative=2)


def children(rec, parent, name=None):
    return [s for s in rec.spans if s.parent is parent
            and (name is None or s.name == name)]


def test_span_tree_of_two_fits(graph):
    with record() as rec:
        hs = deepwalk_hs(graph)
        sgns = node2vec_sgns(graph)
    assert not profiling._open
    roots = [s for s in rec.spans if s.parent is None]
    assert [(s.name, s.fit) for s in roots] == [
        ("walk", hs.fit_id), ("train", hs.fit_id),
        ("walk", sgns.fit_id), ("train", sgns.fit_id)]
    assert hs.fit_id != sgns.fit_id
    assert all(s.end is not None and s.end >= s.start for s in rec.spans)
    for root in roots:
        # children inherit the fit id of their root
        stack = children(rec, root)
        while stack:
            s = stack.pop()
            assert s.fit == root.fit and s.start >= root.start
            assert s.end <= root.end
            stack += children(rec, s)
    for model, train in ((hs, roots[1]), (sgns, roots[3])):
        tables = children(rec, train, "train.tables")
        assert len(tables) == 1
        huffman = children(rec, tables[0], "train.tables.huffman")
        assert len(huffman) == (1 if model is hs else 0)
        assert len(children(rec, train, "train.prepare")) == EPOCHS
        # one chunk an epoch here; each chunk's draws made before it
        chunks = children(rec, train, "chunk")
        assert len(chunks) == EPOCHS
        draws = [s for s in rec.spans if s.name == "train.draws"
                 and s.fit == model.fit_id]
        assert len(draws) == 2 * EPOCHS
        assert all(s.end <= c.start for s, c in zip(draws[::2], chunks))
        assert all(s.end <= c.start for s, c in zip(draws[1::2], chunks))
    # the walks built the graph's views under their span
    assert children(rec, roots[0], "graph.view")
    assert rec.counters["train.steps"] == 2 * EPOCHS * 64
    assert "chunk.hits" not in rec.counters  # the CPU runs the loop


@pytest.mark.parametrize("kind", ["hs", "sgns"])
def test_step_and_block_counters_follow_the_geometry(graph, kind):
    NW = NODES * WALKS
    if kind == "hs":
        geo = block_geometry(NW, LENGTH, fit_block_walks(NW, LENGTH, 504), 1)
        fit = deepwalk_hs
    else:
        cfg = SkipGramConfig()
        geo = block_geometry(NW, LENGTH, plan_block_walks(
            NW, LENGTH, NODES, cfg), cfg.neg_share_packs)
        fit = node2vec_sgns
    chunks = -(-geo.n_blocks // 64)
    with record() as rec:
        fit(graph)
    assert rec.counters["train.blocks"] == geo.n_blocks * EPOCHS == 14
    assert rec.counters["train.steps"] == chunks * 64 * EPOCHS == 128


@pytest.mark.parametrize("fit", [deepwalk_hs, node2vec_sgns])
def test_recording_off_keeps_nothing_and_changes_nothing(graph, fit):
    assert span("a") is span("b")  # the shared no-op
    count("x")
    off = fit(graph, seed=5)
    assert not profiling._recordings and not profiling._open
    with record() as rec:
        on = fit(graph, seed=5)
    assert rec.spans and "x" not in rec.counters
    assert torch.equal(off.walks, on.walks)
    assert torch.equal(off.w_in, on.w_in) and torch.equal(off.w_out,
                                                          on.w_out)
    assert torch.equal(off.losses, on.losses)


@pytest.fixture
def stand_in(monkeypatch):
    """The CPU takes the chunk-graph path through `StandInCapture`; the
    cache is emptied before and after."""
    cg.release()
    monkeypatch.setitem(cg.CAPTURES, "cpu", StandInCapture)
    yield
    cg.release()


def test_cache_counters_and_chunk_spans(graph, stand_in):
    with record() as rec:
        deepwalk_hs(graph)
    assert rec.counters["chunk.captures"] == 1
    assert rec.counters["chunk.hits"] == EPOCHS - 1
    chunks = rec.closed("chunk")
    assert len(chunks) == EPOCHS
    for i, c in enumerate(chunks):
        names = [s.name for s in children(rec, c)]
        assert names == (["chunk.capture"] if i == 0 else []) + [
            "chunk.copy_in", "chunk.replay", "chunk.copy_out"]
        inner = children(rec, c)
        assert all(a.end <= b.start for a, b in zip(inner, inner[1:]))
    assert rec.counters["train.steps"] == EPOCHS * 64


def test_innermost_span_of_a_time():
    rec = profiling.Recording()

    def add(name, start, end, parent=None):
        s = profiling.Span(name, parent, None, {})
        s.start, s.end = start, end
        rec.spans.append(s)
        return s

    outer = add("outer", 10, 20)
    add("inner", 12, 15, outer)
    add("empty", 15, 15, outer)  # holds no instant
    add("open", 16, None, outer)  # not ended: holds nothing
    add("next", 20, 30)
    add("child", 20, 25, rec.spans[-1])
    t = [9, 10, 11, 12, 14, 15, 16, 19, 20, 24, 25, 29, 30]
    assert rec.innermost(t).tolist() == [
        -1, 0, 0, 1, 1, 0, 0, 0, 5, 5, 4, 4, -1]
    assert profiling.Recording().innermost([1, 2]).tolist() == [-1, -1]
    assert rec.wall_s("inner") == 3e-9
    assert [s.name for s in rec.closed()] == [
        "outer", "inner", "empty", "next", "child"]


def test_nested_recordings_share_their_spans():
    with record() as outer:
        with span("a"):
            count("n", 2)
            with record() as inner:
                with span("b"):
                    count("n")
        with span("c"):
            pass
    assert [s.name for s in outer.spans] == ["a", "b", "c"]
    assert [s.name for s in inner.spans] == ["b"]
    assert inner.spans[0].parent is outer.spans[0]
    assert outer.counters == {"n": 3} and inner.counters == {"n": 1}


def test_trace_writes_the_program_spans(tmp_path):
    # the card's activity where there is a card (the runtime calls that
    # launch its kernels), the host's operations where there is none
    on_card = torch.cuda.is_available()
    x = torch.ones(64, device="cuda" if on_card else "cpu")
    with trace(str(tmp_path / "tr")):
        with span("outer", fit=7):
            x.sum()
    doc = json.load(open(tmp_path / "tr" / "trace.json"))
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "program"]
    assert [(e["name"], e["ph"], e["args"]["fit"]) for e in mine] == [
        ("outer", "X", 7)]
    ops = [e for e in doc["traceEvents"] if e.get("ph") == "X" and (
        (e.get("cat") == "cuda_runtime" and "Launch" in e["name"])
        if on_card else e["name"] == "aten::sum")]
    # the profiler's events lie inside the span on the trace's clock
    assert ops and all(
        mine[0]["ts"] <= e["ts"] and e["ts"] + e["dur"]
        <= mine[0]["ts"] + mine[0]["dur"] for e in ops)


@pytest.fixture
def card():
    """torch.device('cuda'), or skip where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_span_holds_its_kernel_launch_on_the_card(card):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1 << 20, device=card)
    x.add_(1)
    torch.cuda.synchronize()
    with record() as rec, profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(20):
            with span("launch", i=i):
                x.add_(1)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    kernels = {e.correlation_id() for e in events
               if e.device_type() == DeviceType.CUDA
               and not e.is_user_annotation()}
    # a launch: the first host call correlated with the kernel (the
    # runtime call; a lower-level call with its id lies inside it)
    launch = {}
    for e in events:
        c = e.correlation_id()
        if e.device_type() != DeviceType.CUDA and c in kernels:
            launch[c] = min(launch.get(c, e.start_ns()), e.start_ns())
    assert len(kernels) == len(launch) == 20
    held = rec.innermost(sorted(launch.values()))
    assert [rec.spans[i].attrs["i"] for i in held] == list(range(20))


@pytest.mark.parametrize("hs", [1, 0])
def test_recording_adds_no_synchronization_on_the_card(card, hs):
    graph = tds.synthetic_wiki(num_nodes=200, num_classes=2, seed=3).graph

    def fit():
        m = DeepWalk(graph, walk_length=10, num_walks=4, seed=0,
                     device=card)
        m.train(embed_size=32, window_size=3, iter=2, hs=hs)
        torch.cuda.synchronize()

    def syncs(recording):
        """Where the fit synchronizes: a count of each calling line."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with record() if recording else contextlib.nullcontext():
                    fit()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return collections.Counter(
            (w.filename, w.lineno) for w in caught
            if "synchroniz" in str(w.message))

    fit()  # the captures
    syncs(False)  # a first warm fit may synchronize once more (lazy state)
    off = syncs(False)
    assert off  # the fit's counts come to the host
    assert syncs(True) == off
