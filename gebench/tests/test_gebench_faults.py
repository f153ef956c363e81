"""A run whose timed path is broken underneath comes out not correct: the
control (the reference in TF32 in the program's place) and each fault a
cell can have, planted in the program, at a size the CPU runs. One chip
only, so no exchange between chips can be left out."""

import numpy as np
import pytest
import torch

from conftest import ROOT, rehearse
from gebench import harness
from gebench.models import walk_skipgram
from graphembedding_tpu_torch.models import deepwalk, node2vec
from graphembedding_tpu_torch.train import hsoftmax, skipgram

CELLS = ["node2vec.blogcatalog", "deepwalk-hs.youtube"]


def test_sound_runs_are_correct():
    for w in CELLS:
        r = rehearse(w)
        assert r["correct"] is True, r["check"]


@pytest.mark.parametrize("workload, size", [
    # sizes at which the control reads 5x its cell's limit or more
    ("node2vec.blogcatalog", dict(num_walks=8, iters=3)),
    ("deepwalk-hs.youtube", dict(num_walks=4, iters=2))])
def test_control_in_the_programs_place(workload, size, monkeypatch):
    """The reference computed in TF32 stands in for the trainer."""
    module = harness.load_cell(ROOT, workload).model
    plain = module.train

    def control(model, cfg):
        plain(model, cfg)  # the fit's shapes; its tables are replaced
        w_in, w_out, _ = walk_skipgram.reference_fit(
            model.walks, model.graph.num_nodes, cfg, model.seed,
            matmul="tf32")
        model.w_in, model.w_out = w_in, w_out

    monkeypatch.setattr(module, "train", control)
    r = rehearse(workload, **size)
    assert r["correct"] is False
    assert r["check"]["table_err"]["value"] > r["check"]["table_err"][
        "limit"]


def unchanged(monkeypatch):
    zero = lambda *a, **k: (torch.zeros(()), torch.zeros(()))  # noqa: E731
    monkeypatch.setattr(skipgram, "sgns_step", zero)
    monkeypatch.setattr(hsoftmax, "hs_step", zero)


def half_batch(monkeypatch):
    plain = skipgram.chunk_blocks

    def half(walks, t0, S, geo):
        blocks = plain(walks, t0, S, geo).clone()
        blocks[:, geo.G // 2:] = -1
        return blocks

    monkeypatch.setattr(skipgram, "chunk_blocks", half)
    monkeypatch.setattr(hsoftmax, "chunk_blocks", half)


def walks_patched(monkeypatch, change):
    for mod in (deepwalk, node2vec):
        plain = mod.simulate_walks

        def walk(graph, *a, _plain=plain, **kw):
            return change(graph, _plain, a, kw)

        monkeypatch.setattr(mod, "simulate_walks", walk)


def token_altered(monkeypatch):
    def change(graph, plain, a, kw):
        w = plain(graph, *a, **kw).clone()
        prev = int(w[0, 4])
        far = np.setdiff1d(np.arange(graph.num_nodes),
                           np.append(graph.neighbors(prev), prev))
        w[0, 5] = int(far[0])
        return w

    walks_patched(monkeypatch, change)


def wrong_law(monkeypatch):
    def change(graph, plain, a, kw):
        if kw.get("kind") == "node2vec":
            kw = dict(kw, kind="uniform")
        else:
            kw = dict(kw, kind="node2vec", p=0.25, q=4.0, sampler="exact")
        return plain(graph, *a, **kw)

    walks_patched(monkeypatch, change)


@pytest.mark.parametrize("workload", CELLS)
@pytest.mark.parametrize("fault, number", [
    (unchanged, "table_err"), (half_batch, "table_err"),
    (token_altered, "bad_hops"), (wrong_law, "law_z")])
def test_fault_in_the_program(workload, fault, number, monkeypatch):
    fault(monkeypatch)
    r = rehearse(workload)
    assert r["correct"] is False
    value = r["check"][number]["value"]
    assert value is None or value > r["check"][number]["limit"]
