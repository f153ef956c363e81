"""The port's multi-process entry points on the CPU.

Counterpart of tests/test_multihost.py: two OS processes of
`graphembedding_tpu_torch.examples.deepwalk_multihost` join one gloo group
through `--coordinator` (a TCP store on localhost), walk over the
(2, 1) mesh and train over it; rank 0's JSON line must report both
processes, no lost walker and micro-F1 at the mode's gate (0.9 dp, 0.7
rowshard). They walk 40 walks a node, not the JAX test's 20: at 2 ranks
the JAX package's own dp scores 0.54-0.58 on 20 and 0.958-1.0 on 40
(tests/test_torch_parallel_models.py). Also the examples' `--mesh` under
`torchrun` (two ranks, both print the same result), and its refusals
without torchrun's environment or with a shape that is not the world size.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

from graphembedding_tpu_torch.examples import common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("mode,gate,walk_engine", [
    ("dp", 0.9, "default"),
    ("rowshard", 0.7, "default"),
    ("dp", 0.9, "a2a"),
])
def test_two_process_deepwalk_end_to_end(tmp_path, mode, gate, walk_engine):
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   p for p in (os.environ.get("PYTHONPATH", ""), ROOT) if p))
    procs, logs = [], []
    for pid in range(2):
        log = open(tmp_path / f"p{pid}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, "-m",
             "graphembedding_tpu_torch.examples.deepwalk_multihost",
             "--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--process-id", str(pid), "--device", "cpu", "--nodes", "120",
             "--num-walks", "40", "--iter", "3", "--json", "--mode", mode,
             "--walk-engine", walk_engine],
            env=env, stdout=log, stderr=subprocess.STDOUT, cwd=str(tmp_path)))
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for log in logs:
            log.close()
    out0 = (tmp_path / "p0.log").read_text()
    assert rcs == [0, 0], out0[-2000:]
    res = json.loads([ln for ln in out0.splitlines()
                      if ln.startswith("{")][-1])
    assert res["processes"] == 2, res
    assert res["walk_overflow"] == 0, res
    assert res["micro_f1"] >= gate, res
    # rank 1 prints no result
    assert not any(ln.startswith("{") for ln in
                   (tmp_path / "p1.log").read_text().splitlines())


def test_example_mesh_under_torchrun(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "graphembedding_tpu_torch.examples.deepwalk_wiki", "--mesh", "2",
         "--device", "cpu", "--dataset", "flight-brazil", "--embed-size",
         "16", "--json"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(ln) for ln in out.stdout.splitlines()
             if ln.startswith("{")]
    for line in lines:
        del line["train_s"]  # each rank's own clock
    assert len(lines) == 2 and lines[0] == lines[1], lines
    assert lines[0]["model"] == "DeepWalk" and 0 < lines[0]["micro"] <= 1


def test_mesh_from_args_refusals(monkeypatch):
    args = common.make_parser("x", "wiki").parse_args(["--mesh", "2x2"])
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        common.mesh_from_args(args)
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    with pytest.raises(ValueError, match="2x2 is 4 ranks"):
        common.mesh_from_args(args)
    assert common.mesh_from_args(
        common.make_parser("x", "wiki").parse_args([])) is None
