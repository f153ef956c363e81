"""Shared pieces of the benchmark's own tests (run them from the checkout's
root: `python -m pytest gebench/tests -q`)."""

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gebench import harness  # noqa: E402

# The names the tests' own model, configuration, traffic, cell and
# per-layer metric take, and a model that has no module: no model of the
# port and no configuration, traffic, cell or metric of the tree takes
# them (a test holds them to that), so a copy of the tree that gains them
# overwrites nothing.
FIXTURE = {"model": "GebenchStub", "config": "gebench-stub",
           "traffic": "gebench-stub-graph",
           "cell": "gebench-stub.gebench-stub-graph",
           "metric": "gebench-stub.reading",
           "absent_model": "GebenchAbsent", "absent_config": "gebench-absent"}
# The walk family's cells, each judged by `walk_skipgram.judge`.
WALK_CELLS = ["node2vec.blogcatalog", "deepwalk-hs.youtube",
              "node2vec.youtube", "deepwalk-hs.blogcatalog"]


def tiny(cell, nodes=300, avg_degree=8, num_walks=4, iters=2):
    """The cell at a size the CPU runs in a second or two."""
    cell.traffic = dict(cell.traffic, nodes=nodes, avg_degree=avg_degree)
    cell.config = dict(cell.config, num_walks=num_walks, iter=iters)
    return cell


def rehearse(workload, seed=20231, seconds=0.2, root=ROOT, **size):
    """The last line's object of a CPU rehearsal of `workload`, tiny."""
    cell = tiny(harness.load_cell(root, workload), **size)
    return harness.run_cell(cell, seed, seconds, False, torch.device("cpu"),
                            "cpu", time.perf_counter(),
                            log=lambda *a, **k: None)


@pytest.fixture
def cuda():
    """torch.device('cuda'), or skip where there is no card. Decided when
    the test runs, so every test process collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
