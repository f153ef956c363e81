"""The benchmark's arithmetic on small known cases: Huffman code lengths,
the rooflines, mfu, the idle shares, and operations by launching span;
and the work and check of each cell's rehearsal against the fit and check
written out from the port's API and the reference alone."""

import numpy as np
import pytest
import torch

from conftest import ROOT, WALK_CELLS, rehearse, tiny
from gebench import graphgen, harness, profiling
from gebench.models import walk_skipgram
from gebench.reference import tables
from gebench.reference import train as ref_train
from gebench.reference import walks as ref_walks

PEAKS = {"fp32_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}


@pytest.mark.parametrize("weights, lengths", [
    ([1, 1, 1, 1], [2, 2, 2, 2]),
    ([1, 1, 2], [2, 2, 1]),
    ([1, 2, 4, 8], [3, 3, 2, 1]),
    ([5, 5], [1, 1]),
])
def test_huffman_code_lengths(weights, lengths):
    got = tables.huffman_code_lengths(np.asarray(weights, np.float64))
    assert got.tolist() == lengths


def test_mean_code_length_weights_by_degree():
    # degrees 1, 2, 4, 8: lengths 3, 3, 2, 1; (3 + 6 + 8 + 8) / 15
    assert walk_skipgram.mean_code_length(
        np.array([1, 2, 4, 8])) == pytest.approx(25 / 15)


def test_huffman_code_paths_root_first():
    points, codes = tables.huffman_code(np.array([1.0, 2.0, 4.0, 8.0]))
    # merges: (0, 1) -> 0, (inner 0, 2) -> 1, (3, inner 1) -> 2 = root;
    # node 3 weighs 8 > 7 = inner 1, so inner 1 is the root's first child
    assert points.tolist() == [[2, 1, 0], [2, 1, 0], [2, 1, -1],
                               [2, -1, -1]]
    assert codes.tolist() == [[0, 0, 0], [0, 0, 1], [0, 1, 0], [1, 0, 0]]


def cell(objective="sgns"):
    cfg = {"num_walks": 2, "iter": 3, "walk_length": 10, "window_size": 5,
           "embed_size": 128, "negative": 5, "objective": objective}
    return harness.Cell("c", 1, cfg, {}, {}, ["pairs_per_s"], {},
                        harness.model_module("DeepWalk"))


def spans():
    # two fits: walk 1 s then train 3 s each, a 1 s gap between them
    return [{"fit": 0, "walk": (0.0, 1e6), "train": (1e6, 4e6)},
            {"fit": 1, "walk": (5e6, 6e6), "train": (6e6, 9e6)}]


def test_ops_belong_to_the_span_that_launched_them():
    ops = profiling.Ops.from_list([
        ("w", 0.5e6, 0.9e6, 0.1e6), ("t", 1.5e6, 2.5e6, 0.99e6),
        ("t2", 6.5e6, 7.0e6, 6.2e6), ("x", 4.2e6, 4.3e6, 4.1e6),
        ("y", 8.0e6, 8.1e6, None)])
    kinds = harness.label_ops(ops, spans()).tolist()
    # launched late in the walk span, run in the train span: still walk's
    assert kinds == ["walk", "walk", "train", "other", "other"]


def test_layer_readers_on_a_known_run():
    run = harness.Run(cell(), V=1000, E=4000, window_s=10.0, spans=spans(),
                      peaks=PEAKS)
    run.ops = profiling.Ops.from_list([
        ("w", 0.2e6, 0.4e6, 0.1e6), ("w", 5.2e6, 5.4e6, 5.1e6),
        ("t", 1e6, 2.5e6, 1.1e6), ("t", 6e6, 7.5e6, 6.1e6)])
    run.kind = harness.label_ops(run.ops, spans())
    assert run.kind.tolist() == ["walk", "walk", "train", "train"]
    run.busy_s = 3.4
    read = {n: harness.metric_reader(n)(run)
            for n in ("walk.share", "walk.roofline", "train.roofline",
                      "train.idle_share", "device.idle_share", "mfu")}
    assert read["walk.share"] == pytest.approx(25.0)
    walk_bytes = 4 * 1001 + 4 * 4000 + 2 * 1000 * 10 * 4
    assert read["walk.roofline"] == pytest.approx(
        100 * 2 * walk_bytes / 1e9 / 0.4)
    pairs = 2 * 1000 * 3 * 46 * 2
    flops = pairs * 6 * 128 * 6
    tbytes = 2 * 2000 * 128 * 4 * 3 * 2
    assert read["train.roofline"] == pytest.approx(
        100 * max(flops / 1e12, tbytes / 1e9) / 3.0)
    assert read["train.idle_share"] == pytest.approx(50.0)
    assert read["device.idle_share"] == pytest.approx(66.0)
    assert read["mfu"] == pytest.approx(100 * flops / 10.0 / 1e12)


def test_readers_return_nothing_without_a_trace():
    run = harness.Run(cell("hs"), V=1000, E=4000, window_s=10.0,
                      spans=spans(), peaks=PEAKS)
    for name in ("walk.roofline", "train.roofline", "train.idle_share",
                 "device.idle_share", "mfu"):
        # hs=1 without its mean code length has no FLOPs to count
        assert harness.metric_reader(name)(run) is None


def test_idle_gaps_are_labelled_by_the_host_span():
    ops = profiling.Ops.from_list([
        ("a", 0.0, 0.5e6, None), ("b", 1.0e6, 3.0e6, None),
        ("c", 5.0e6, 9.0e6, None), ("d", 5.5e6, 6.0e6, None)])
    gaps = harness.idle_gaps(ops, spans(), 0.0, 9.0e6, 10)
    assert len(gaps) == 2
    assert gaps[0] == ["train of fit 0, 2.0000 s in", 2.0]
    assert gaps[1] == ["walk of fit 0, 0.5000 s in", 0.5]


def test_busy_time_is_the_union_of_intervals():
    assert profiling.busy_us([0, 1, 5, 6], [2, 3, 9, 7]) == 7.0
    assert profiling.busy_us([], []) == 0.0
    ops = profiling.Ops.from_list([("a", 0, 3, 0), ("b", 1, 2, 0),
                                   ("a", 4, 5, 0)])
    assert profiling.top_ops(ops, 10) == [["a", 4e-6], ["b", 1e-6]]


def written_out_fit(cfg, traffic, seed):
    """(V, E, check values) of one fit from `seed`, made straight from the
    port's model API and judged straight by the reference: what a cell's
    walk model ran and its check read before the model modules."""
    from graphembedding_tpu_torch import DeepWalk, Graph, Node2Vec

    cpu = torch.device("cpu")
    row_ptr, col = graphgen.synthetic_csr(
        traffic["nodes"], traffic["avg_degree"], traffic["graph_seed"], cpu)
    graph = Graph.from_csr(row_ptr.numpy(), col.numpy(), directed=False)
    kw = dict(walk_length=cfg["walk_length"], num_walks=cfg["num_walks"],
              seed=seed, device=cpu)
    model = (Node2Vec(graph, p=cfg["p"], q=cfg["q"], **kw)
             if cfg["walk"] == "node2vec" else DeepWalk(graph, **kw))
    train = dict(embed_size=cfg["embed_size"],
                 window_size=cfg["window_size"], iter=cfg["iter"],
                 alpha=cfg["alpha"], min_alpha=cfg["min_alpha"],
                 sample=cfg["sample"])
    hs = cfg["objective"] == "hs"
    model.train(**train, **({"hs": 1} if hs else
                            {"negative": cfg["negative"]}))
    csr = ref_walks.Csr(row_ptr, col)
    law = torch.Generator().manual_seed(harness.derive_seed(20231, 4, 0))
    sched = cfg["schedule"]
    ref_kw = dict(D=cfg["embed_size"], window=cfg["window_size"],
                  epochs=cfg["iter"], seed=seed + 1,
                  sched=ref_train.Schedule(
                      block_walks=sched["block_walks"],
                      chunk_steps=sched["chunk_steps"],
                      update_cap=sched["update_cap"], alpha=cfg["alpha"],
                      min_alpha=cfg["min_alpha"], sample=cfg["sample"],
                      k_shared=sched.get("k_shared", 64),
                      neg_share_packs=sched.get("neg_share_packs", 4),
                      upscale=sched.get("upscale", True)))
    V = csr.V
    r_in, r_out, r_in0 = (
        ref_train.hs_fit(model.walks, V, **ref_kw) if hs else
        ref_train.sgns_fit(model.walks, V, negative=cfg["negative"],
                           **ref_kw))
    err = max(float(torch.linalg.vector_norm(model.w_in - r_in)
                    / torch.linalg.vector_norm(r_in - r_in0)),
              float(torch.linalg.vector_norm(model.w_out - r_out)
                    / torch.linalg.vector_norm(r_out)))
    return V, int(col.shape[0]), {
        "bad_hops": ref_walks.bad_hops(model.walks, csr, cfg["num_walks"],
                                       cfg["walk_length"]),
        "law_z": ref_walks.law_z(model.walks, csr, cfg["walk"],
                                 cfg.get("p", 1.0), cfg.get("q", 1.0),
                                 20000, law),
        "table_err": err}


@pytest.mark.parametrize("workload", WALK_CELLS)
def test_a_rehearsal_reads_the_written_out_work_and_check(workload):
    """One fit in the window (0 s): the fit of seed derive_seed(20231, 2,
    0) is the one judged."""
    cell = tiny(harness.load_cell(ROOT, workload))
    cfg = cell.config
    V, E, want = written_out_fit(cfg, cell.traffic,
                                 harness.derive_seed(20231, 2, 0))
    assert cell.model.nominal_pairs(cfg, V, E) == pytest.approx(
        cfg["num_walks"] * V * cfg["iter"] * 46.0)
    r = rehearse(workload, seed=20231, seconds=0.0)
    assert r["attempted"] == 1 and r["correct"] is True
    assert {n: c["value"] for n, c in r["check"].items()} == want
