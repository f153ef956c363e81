"""BENCHMARK.json against the benchmark's contract, and the harness
finding each file by name."""

import hashlib
import json
import os
import re
import shutil
import time

import pytest
import torch

import contract
import stub_model
from conftest import FIXTURE, ROOT, WALK_CELLS, rehearse
from gebench import harness
from gebench.models import walk_skipgram

NAME = contract.NAME
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    return contract.bench(ROOT)


def copy_of_the_tree(tmp_path):
    """BENCHMARK.json and gebench/ as they are, under `tmp_path`."""
    shutil.copytree(os.path.join(ROOT, "gebench"), tmp_path / "gebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    return str(tmp_path)


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


def reexport(names):
    """A model module's text that re-exports `names` of the stub."""
    return ('"""The tests\' stub model (gebench/tests/stub_model.py)."""\n'
            f"from stub_model import {', '.join(names)}  # noqa: F401\n")


def add_cell(root, model, config, traffic, module_text,
             limits=(("embed_gap", 1e-5),)):
    """A cell of the model `model` on a tiny graph, added to the copy at
    `root` as new files (`module_text` its model module) and entries
    appended to its BENCHMARK.json. Returns the cell's name."""
    cell = f"{config}.{traffic}"
    b = contract.bench(root)
    source = "https://github.com/shenweichen/GraphEmbedding"
    b["configs"].append({"name": config, "source": source, "reduced": [],
                         "file": f"gebench/configs/{config}.json",
                         "why": "a test's fixture"})
    b["workloads"].append({"name": cell, "config": config,
                           "traffic": traffic, "chips": 1,
                           "why": "a tiny graph"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(b, f)
    files = {
        ("models", model.lower() + ".py"): module_text,
        ("configs", config + ".json"): json.dumps(
            {"name": config, "source": source, "model": model,
             "hidden_size": [16, 8], "epochs": 2}),
        ("cells", cell + ".json"): json.dumps({"limits": dict(limits)}),
        ("traffic", traffic + ".json"): json.dumps(
            {"name": traffic, "nodes": 200, "avg_degree": 6,
             "graph_seed": 1})}
    for parts, text in files.items():
        path = os.path.join(root, "gebench", *parts)
        assert not os.path.exists(path), path
        with open(path, "w") as f:
            f.write(text)
    return cell


def assert_only_added(root, before, old):
    """Every file of `before` is byte-identical but BENCHMARK.json, which
    only gained entries."""
    after = tree_digests(root)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == {
        k: v for k, v in before.items() if k != "BENCHMARK.json"}
    b = contract.bench(root)
    for key, entries in old.items():
        if isinstance(entries, list):
            assert b[key][:len(entries)] == entries
        else:
            assert b[key] == entries


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
    """Every cell, whatever its model, keeps the contract."""
    assert contract.problems(ROOT) == []


def test_the_walk_family_keeps_its_own_checks():
    """The cells judged by `walk_skipgram.judge`, today's four among them:
    walks of 10, its three checks, the Huffman build's reader where
    hs=1."""
    assert set(WALK_CELLS) <= set(contract.walk_cells(ROOT))
    assert contract.walk_problems(ROOT) == []


def test_the_fixture_names_are_no_real_names():
    from graphembedding_tpu_torch import __all__ as port_names

    b = bench()
    models = {n.lower() for n in port_names}
    models |= {os.path.splitext(f)[0] for f in os.listdir(
        os.path.join(ROOT, "gebench", "models"))}
    real = {c["name"] for c in b["configs"]}
    real |= {w[k] for w in b["workloads"] for k in ("name", "traffic")}
    real |= {m["name"] for m in b["end_to_end"] + b["per_layer"]}
    for d in ("configs", "cells", "traffic", "metrics"):
        real |= {os.path.splitext(f)[0] for f in os.listdir(
            os.path.join(ROOT, "gebench", d))}
    assert {"sdne", "line", "struc2vec"} <= models
    for key, name in FIXTURE.items():
        assert NAME.match(name), key
        assert name.lower() not in models and name not in real, key


def test_a_traffic_file_added_to_a_copy_becomes_a_cell(tmp_path):
    """No code edit: a new traffic file and a workload entry run."""
    copy_of_the_tree(tmp_path)
    b = bench()
    traffic = FIXTURE["traffic"]
    b["workloads"].append({"name": f"node2vec.{traffic}",
                           "config": "node2vec", "traffic": traffic,
                           "chips": 1, "why": "a tiny graph"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "gebench" / "traffic" / f"{traffic}.json").write_text(
        json.dumps({"name": traffic, "nodes": 200, "avg_degree": 6,
                    "graph_seed": 1}))
    # no cell file: no cut, and no limits until its readings set them, so
    # only calibrate.py's way of loading it takes it
    with pytest.raises(SystemExit, match="no limit for"):
        harness.load_cell(str(tmp_path), f"node2vec.{traffic}")
    cell = harness.load_cell(str(tmp_path), f"node2vec.{traffic}",
                             limits=False)
    assert cell.traffic["nodes"] == 200 and cell.config["num_walks"] == 80
    assert cell.config["iter"] == 3 and cell.limits == {}
    with pytest.raises(SystemExit):
        harness.load_cell(str(tmp_path), "node2vec.absent")


@pytest.mark.parametrize("model", [FIXTURE["model"], "SDNE", "LINE",
                                   "Struc2Vec"])
def test_a_model_the_benchmark_does_not_run_becomes_a_cell(model, tmp_path):
    """No code edit: a model that no cell runs becomes a runnable cell by
    a model module (the stub, which trains the port's SDNE whatever name
    it stands under), a configuration, a cell file, a traffic file and
    the entries that name them, under the tests' own names or under the
    lower-case name of a model the port has; the copy then keeps the
    whole contract. Once the tree has that model's own module, a cell of
    the tree runs it and keeps the contract instead."""
    module = os.path.join(ROOT, "gebench", "models", model.lower() + ".py")
    if os.path.exists(module):
        runs = [w["name"] for w in bench()["workloads"]
                if os.path.abspath(harness.load_cell(
                    ROOT, w["name"]).model.__file__) == module]
        assert runs, f"no cell runs {os.path.relpath(module, ROOT)}"
        assert contract.problems(ROOT) == []
        return
    if model != FIXTURE["model"]:
        from graphembedding_tpu_torch import __all__ as port_names

        assert model in port_names
    config = FIXTURE["config"] if model == FIXTURE["model"] else model.lower()
    root = copy_of_the_tree(tmp_path)
    old = bench()
    before = tree_digests(root)
    with open(stub_model.__file__) as f:
        name = add_cell(root, model, config, FIXTURE["traffic"], f.read())

    cell = harness.load_cell(root, name)
    assert cell.model.CHECKS == ("embed_gap",)
    r = harness.run_cell(cell, 2**31 + 12345, 0.05, False,
                         torch.device("cpu"), "cpu", time.perf_counter(),
                         log=lambda *a, **k: None)
    assert r["correct"] is True, r["check"]
    assert r["check"]["embed_gap"]["limit"] == 1e-5
    assert r["metrics"]["pairs_per_s"]["value"] > 0
    assert_only_added(root, before, old)
    assert contract.problems(root) == []
    assert contract.walk_cells(root) == contract.walk_cells(ROOT)
    assert set(WALK_CELLS) <= set(contract.walk_cells(root))
    assert contract.walk_problems(root) == []


@pytest.mark.parametrize("lacks", ["judge", "limit", "workloads"])
def test_the_contract_finds_what_a_new_cell_lacks(lacks, tmp_path):
    """A module without `judge`, a cell file without a limit for one of
    its CHECKS, or a per-layer entry without the list of the cells it is
    read in, is a problem."""
    root = copy_of_the_tree(tmp_path)
    names = [n for n in contract.INTERFACE + ("CHECKS",) if n != lacks]
    name = add_cell(root, FIXTURE["model"], FIXTURE["config"],
                    FIXTURE["traffic"], reexport(names),
                    limits=() if lacks == "limit" else
                    (("embed_gap", 1e-5),))
    if lacks == "workloads":
        assert contract.problems(root) == []  # sound until the entry comes
        metric = FIXTURE["metric"]
        b = contract.bench(root)
        b["per_layer"].append({
            "name": metric, "unit": "ms", "better": "lower",
            "source": "program_span", "layer": "a test's fixture",
            "moves": "pairs_per_s"})
        with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
            json.dump(b, f)
        with open(os.path.join(root, "gebench", "metrics",
                               metric + ".py"), "w") as f:
            f.write("def read(run):\n    return None\n")
    found = contract.problems(root)
    want = {"judge": f"cell {name}: no function judge",
            "limit": f"cell {name}: ",
            "workloads": f"metric {FIXTURE['metric']}: no list"}[lacks]
    assert any(p.startswith(want) for p in found), found
    if lacks == "limit":
        assert any("no limit for" in p for p in found), found
    if lacks != "workloads":
        assert all(p.startswith(f"cell {name}: ") for p in found), found


@pytest.mark.parametrize("change, want", [
    ({"walk_length": 20}, "walk_length 20"),
    ({"objective": None}, "no objective")], ids=["walk_length", "objective"])
def test_the_walk_check_finds_what_a_walk_config_breaks(change, want,
                                                        tmp_path):
    """A walk config whose walks are not of 10, or that states no
    objective, is a problem of the walk family's check alone."""
    root = copy_of_the_tree(tmp_path)
    path = os.path.join(root, "gebench", "configs", "node2vec.json")
    with open(path) as f:
        config = json.load(f)
    config.update(change)
    with open(path, "w") as f:
        json.dump({k: v for k, v in config.items() if v is not None}, f)
    assert contract.problems(root) == []
    found = contract.walk_problems(root)
    assert found and all(want in p for p in found), found
    assert {p.split(":")[0] for p in found} == {
        f"cell {w['name']}" for w in bench()["workloads"]
        if w["config"] == "node2vec"}


def test_a_model_without_a_module_fails_at_load(tmp_path):
    copy_of_the_tree(tmp_path)
    model, config = FIXTURE["absent_model"], FIXTURE["absent_config"]
    b = bench()
    b["configs"].append({"name": config, "source": "https://example.org",
                         "reduced": [],
                         "file": f"gebench/configs/{config}.json",
                         "why": "no module"})
    b["workloads"].append({"name": f"{config}.blogcatalog", "config": config,
                           "traffic": "blogcatalog", "chips": 1,
                           "why": "no module"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    (tmp_path / "gebench" / "configs" / f"{config}.json").write_text(
        json.dumps({"name": config, "model": model}))
    with pytest.raises(SystemExit,
                       match=f"gebench/models/{model.lower()}.py"):
        harness.load_cell(str(tmp_path), f"{config}.blogcatalog")
    assert f"{config}.blogcatalog: no model module" in " ".join(
        contract.problems(str(tmp_path)))


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
