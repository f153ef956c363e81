"""`graphembedding_tpu_torch/benchmarks/scaling.py` at a tiny size on the
CPU: one spawn of two gloo ranks on a 300-node graph, one chunk and one
timed run of each configuration; every row of the JAX harness's with its
keys, and numbers that are finite and positive where they count work."""

import math

import pytest

from graphembedding_tpu_torch.benchmarks import scaling

TRAIN_KEYS = {"devices", "mode", "pairs_per_s", "scaling_efficiency",
              "comm_efficiency", "seconds", "backend", "card"}
WALK_KEYS = {"devices", "mode", "walked_edges_per_s", "scaling_efficiency",
             "comm_efficiency", "routing_rounds", "overflow", "seconds",
             "backend", "card"}


def test_scaling_rows_on_two_gloo_ranks(tmp_path):
    out = tmp_path / "rows.jsonl"
    rows = scaling.main(["--world", "2", "--backend", "gloo", "--device",
                         "cpu", "--nodes", "300", "--chunks", "1", "--reps",
                         "1", "--walkers", "256", "--out", str(out)])
    assert [r["mode"] for r in rows] == [
        "train_dp_weak", "rowshard", "distributed_walks_weak",
        "distributed_walks_a2a_weak"]
    assert all(r["devices"] == 2 and r["backend"] == "gloo"
               and r["card"] == "cpu" for r in rows)
    train, rowshard, walks, a2a = rows
    assert set(train) == TRAIN_KEYS
    assert set(rowshard) == {"devices", "mode", "pairs_per_s", "seconds",
                             "backend", "card"}
    assert set(walks) == WALK_KEYS
    assert set(a2a) == WALK_KEYS | {"crossed_rows_total",
                                    "crossed_per_shard_round"}
    for r in rows:
        rate = r.get("pairs_per_s", r.get("walked_edges_per_s"))
        assert rate > 0 and math.isfinite(rate) and r["seconds"] > 0
    # the first world size is the base of the efficiencies
    assert train["scaling_efficiency"] == walks["scaling_efficiency"] == 1.0
    for r in (train, walks, a2a):
        assert 0 < r["comm_efficiency"] <= 1.0
    assert walks["overflow"] == a2a["overflow"] == 0
    assert walks["routing_rounds"] is None and a2a["routing_rounds"] > 0
    assert a2a["crossed_rows_total"] > 0
    assert len(out.read_text().splitlines()) == len(rows)


def test_scaling_refuses_nccl_off_the_card():
    with pytest.raises(SystemExit):
        scaling.parse_args(["--backend", "nccl", "--device", "cpu"])
