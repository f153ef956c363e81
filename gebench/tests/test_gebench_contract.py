"""BENCHMARK.json against the benchmark's contract, and the harness
finding each file by name."""

import hashlib
import json
import os
import re
import shutil
import textwrap
import time

import pytest
import torch

from conftest import ROOT, rehearse
from gebench import harness
from gebench.models import walk_skipgram

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]]
    names += [w["name"] for w in b["workloads"]]
    names += [w["config"] for w in b["workloads"]]
    names += [w["traffic"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in b["workloads"]]
                 + [c["why"] for c in b["configs"]]
                 + [m["layer"] for m in b["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(set(m["name"] for m in b["end_to_end"] + b["per_layer"])) \
        == len(b["end_to_end"]) + len(b["per_layer"])


def test_every_config_traffic_cell_and_metric_is_found_by_name():
    b = bench()
    for c in b["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("gebench/") and os.path.exists(path)
        with open(path) as f:
            assert json.load(f)["source"] == c["source"]
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= cells, m["name"]
    for w in b["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert cell.config["walk_length"] == 10
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits) == set(cell.model.CHECKS) == {
            "bad_hops", "law_z", "table_err"}
        assert cell.end_to_end == ["pairs_per_s", "setup_s"]
        assert cell.per_layer == {m["name"]: m["unit"]
                                  for m in b["per_layer"]
                                  if w["name"] in m["workloads"]}
        # the Huffman build is hs=1's alone
        assert ("train.huffman_ms" in cell.per_layer) == (
            cell.config["objective"] == "hs")
        for name in cell.per_layer:
            assert callable(harness.metric_reader(name))


def test_a_traffic_file_added_to_a_copy_becomes_a_cell(tmp_path):
    """No code edit: a new traffic file and a workload entry run."""
    shutil.copytree(os.path.join(ROOT, "gebench"), tmp_path / "gebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["workloads"].append({"name": "node2vec.tiny", "config": "node2vec",
                           "traffic": "tiny", "chips": 1,
                           "why": "a tiny graph"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "gebench" / "traffic" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "nodes": 200, "avg_degree": 6, "graph_seed": 1}))
    # no cell file: no cut, and no limits until its readings set them, so
    # only calibrate.py's way of loading it takes it
    with pytest.raises(SystemExit, match="no limit for"):
        harness.load_cell(str(tmp_path), "node2vec.tiny")
    cell = harness.load_cell(str(tmp_path), "node2vec.tiny", limits=False)
    assert cell.traffic["nodes"] == 200 and cell.config["num_walks"] == 80
    assert cell.config["iter"] == 3 and cell.limits == {}
    with pytest.raises(SystemExit):
        harness.load_cell(str(tmp_path), "node2vec.absent")


SDNE_MODULE = '''
    """SDNE at a size the CPU runs: a test's model module, not one of the
    benchmark's."""
    import torch

    CHECKS = ("embed_gap",)


    def build(graph, cfg, seed, device):
        from graphembedding_tpu_torch import SDNE

        return SDNE(graph, hidden_size=cfg["hidden_size"], seed=seed,
                    device=device)


    def train(fit, cfg):
        fit.train_sparse(epochs=cfg["epochs"])


    def run_constants(cfg, row_ptr, col):
        return {}


    def nominal_pairs(cfg, V, E):
        return V * V * cfg["epochs"]


    def model_flops(cfg, V, E, constants):
        return None


    def walk_bytes(cfg, V, E):
        return None


    def train_bytes(cfg, V, E):
        return None


    def outputs(fit):
        return ({k: v.detach().clone() for k, v in
                 fit.net.state_dict().items()}, fit.embedding_table)


    def judge(outputs, fit_seed, cfg, csr, law_seed):
        """The largest gap of the trained embeddings from the encoder
        recomputed in plain torch on the dense adjacency (a repeated edge
        counted each time), relative to the largest embedding."""
        params, table = outputs
        x = torch.zeros(csr.V, csr.V)
        x.index_put_((torch.repeat_interleave(torch.arange(csr.V), csr.deg),
                      csr.col), torch.ones(csr.col.shape), accumulate=True)
        for i in range(len(cfg["hidden_size"])):
            x = torch.relu(x @ params[f"enc.{i}.w"] + params[f"enc.{i}.b"])
        return {"embed_gap": float((table - x).abs().max()
                                   / x.abs().max())}
'''


def tree_digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" not in d:
                path = os.path.join(d, f)
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_a_model_the_benchmark_does_not_run_becomes_a_cell(tmp_path):
    """No code edit: SDNE, which no cell runs, becomes a runnable cell by
    a model module, a configuration, a cell file, a traffic file and the
    entries that name them."""
    shutil.copytree(os.path.join(ROOT, "gebench"), tmp_path / "gebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    old = bench()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(old))
    before = tree_digests(tmp_path)
    b = json.loads(json.dumps(old))
    b["configs"].append({"name": "sdne", "source": "https://github.com/"
                         "shenweichen/GraphEmbedding", "reduced": [],
                         "file": "gebench/configs/sdne.json",
                         "why": "a test's fixture"})
    b["workloads"].append({"name": "sdne.tiny", "config": "sdne",
                           "traffic": "tiny", "chips": 1,
                           "why": "a tiny graph"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    here = tmp_path / "gebench"
    (here / "models" / "sdne.py").write_text(
        textwrap.dedent(SDNE_MODULE).lstrip())
    (here / "configs" / "sdne.json").write_text(json.dumps(
        {"name": "sdne", "source": b["configs"][-1]["source"],
         "model": "SDNE", "hidden_size": [16, 8], "epochs": 2}))
    (here / "cells" / "sdne.tiny.json").write_text(json.dumps(
        {"limits": {"embed_gap": 1e-5}}))
    (here / "traffic" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "nodes": 200, "avg_degree": 6, "graph_seed": 1}))

    cell = harness.load_cell(str(tmp_path), "sdne.tiny")
    assert cell.model.CHECKS == ("embed_gap",)
    r = harness.run_cell(cell, 2**31 + 12345, 0.05, False,
                         torch.device("cpu"), "cpu", time.perf_counter(),
                         log=lambda *a, **k: None)
    assert r["correct"] is True, r["check"]
    assert r["check"]["embed_gap"]["limit"] == 1e-5
    assert r["metrics"]["pairs_per_s"]["value"] > 0
    after = tree_digests(tmp_path)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == {
        k: v for k, v in before.items() if k != "BENCHMARK.json"}
    # BENCHMARK.json only gained entries
    for key, entries in old.items():
        if isinstance(entries, list):
            assert b[key][:len(entries)] == entries
        else:
            assert b[key] == entries


def test_a_model_without_a_module_fails_at_load(tmp_path):
    shutil.copytree(os.path.join(ROOT, "gebench"), tmp_path / "gebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    b["configs"].append({"name": "line", "source": "https://example.org",
                         "reduced": [], "file": "gebench/configs/line.json",
                         "why": "no module"})
    b["workloads"].append({"name": "line.blogcatalog", "config": "line",
                           "traffic": "blogcatalog", "chips": 1,
                           "why": "no module"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "gebench" / "configs" / "line.json").write_text(
        json.dumps({"name": "line", "model": "LINE"}))
    with pytest.raises(SystemExit, match="gebench/models/line.py"):
        harness.load_cell(str(tmp_path), "line.blogcatalog")


def test_nominal_pairs_match_a_hand_count():
    # d = 1..5: 2 (10 - d) (6 - d) / 5 = 18 + 12.8 + 8.4 + 4.8 + 2
    ws = walk_skipgram
    assert ws.pairs_per_walk(10, 5) == pytest.approx(46.0)
    assert ws.pairs_per_walk(3, 1) == pytest.approx(4.0)
    cfg = {"num_walks": 80, "iter": 3, "walk_length": 10, "window_size": 5}
    assert ws.nominal_pairs(cfg, 10312, 335140) == pytest.approx(113_844_480)
    cfg = {"num_walks": 1, "iter": 1, "walk_length": 10, "window_size": 5}
    assert ws.nominal_pairs(cfg, 1_138_499, 0) == pytest.approx(52_370_954)


def test_rehearsal_line_has_the_driver_keys():
    r = rehearse("node2vec.blogcatalog")
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"pairs_per_s", "setup_s"}
    assert r["metrics"]["pairs_per_s"]["unit"] == "pairs/s"
    assert r["attempted"] >= 1 and r["correct"] is True
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
