"""The command itself on a card: a short run of a cell, its last line as
the driver reads it. Skips where there is no card (decided when the test
runs)."""

import json
import subprocess
import sys

from conftest import ROOT


def test_a_short_run_on_the_card(cuda):
    out = subprocess.run(
        [sys.executable, "gebench/run.py", "--workload",
         "node2vec.blogcatalog", "--seed", "2147483999", "--seconds", "2",
         "--trace", "1"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["check"]
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert {"walk.share", "walk.roofline", "train.roofline",
            "train.idle_share", "device.idle_share", "mfu"} <= set(
                r["metrics"])
    # the program's spans and counters, read where it recorded them
    assert {"train.tables_ms", "train.step_roofline", "train.prepare_ms",
            "chunk.copy_ms", "train.step_use", "chunk.hit_rate"} <= set(
                r["metrics"])
    assert "train.huffman_ms" not in r["metrics"]  # SGNS builds no tree
    for name in ("walk.roofline", "train.roofline", "mfu",
                 "train.step_roofline"):
        assert 0 < r["metrics"][name]["value"] <= 100
    assert len(r["breakdown"]["device_ops"]) <= 10
    assert list(r)[-1] == "check"
