"""BENCHMARK.json against the benchmark's contract, and the harness
finding each file by name."""

import json
import os
import re
import shutil

import pytest

from conftest import ROOT, rehearse
from gebench import harness, work

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
    for w in b["workloads"]:
        cell = harness.load_cell(ROOT, w["name"])
        assert cell.config["walk_length"] == 10
        assert cell.traffic["name"] == w["traffic"]
        assert set(cell.limits) == {"bad_hops", "law_z", "table_err"}
        assert cell.end_to_end == ["pairs_per_s", "setup_s"]
        assert cell.per_layer == {m["name"]: m["unit"]
                                  for m in b["per_layer"]}
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
    cell = harness.load_cell(str(tmp_path), "node2vec.tiny")
    assert cell.traffic["nodes"] == 200 and cell.config["num_walks"] == 80
    # no cell file: no cut, and no limits until its readings set them
    assert cell.config["iter"] == 3 and cell.limits == {}
    with pytest.raises(SystemExit):
        harness.load_cell(str(tmp_path), "node2vec.absent")


def test_nominal_pairs_match_a_hand_count():
    # d = 1..5: 2 (10 - d) (6 - d) / 5 = 18 + 12.8 + 8.4 + 4.8 + 2
    assert work.pairs_per_walk(10, 5) == pytest.approx(46.0)
    assert work.pairs_per_walk(3, 1) == pytest.approx(4.0)
    cfg = {"num_walks": 80, "iter": 3, "walk_length": 10, "window_size": 5}
    assert work.nominal_pairs(cfg, 10312) == pytest.approx(113_844_480)
    cfg = {"num_walks": 1, "iter": 1, "walk_length": 10, "window_size": 5}
    assert work.nominal_pairs(cfg, 1_138_499) == pytest.approx(52_370_954)


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
