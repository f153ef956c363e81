"""Readings that the check's limits are set from, at a cell's own size on
the card:

    python3 gebench/calibrate.py --workload <name> --seeds 12
        [--controls 3] [--base 5000]

For each of `--seeds` seeds, the program's fit (built and trained by the
cell's model module on the cell's graph, as a window fit is) judged by
the module's `judge`: the lower readings. For each of the first
`--controls` seeds, the control and the faults of the module's
`controls` on that fit's outputs (for the walk models: the reference in
TF32 in the program's place, half of every step's walks left out, the
state left unchanged, a token altered where it was walked, the other
walk's law; `models/walk_skipgram.py`). One JSON line a reading on
standard output. Not run by the benchmark's runs; needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--base", type=int, default=5000)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gebench import harness, profiling
    from gebench.reference.walks import Csr

    device, card = profiling.require_card(1)
    cell = harness.load_cell(ROOT, args.workload, limits=False)
    cfg, model = cell.config, cell.model

    def line(**kw):
        print(json.dumps(dict(cell=cell.name, card=card, **kw)), flush=True)

    for i in range(args.seeds):
        seed = args.base + i
        row_ptr, col, graph = harness.cell_graph(cell, device)
        csr = Csr(row_ptr, col)
        s = harness.derive_seed(seed, 2, 0)
        law_seed = harness.derive_seed(seed, 4, 0)
        t0 = time.perf_counter()
        fit = model.build(graph, cfg, s, device)
        model.train(fit, cfg)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        outputs = model.outputs(fit)
        del fit
        graph.free_device()
        t0 = time.perf_counter()
        vals = model.judge(outputs, s, cfg, csr, law_seed)
        line(kind="program", seed=seed, fit_s=fit_s,
             check_s=time.perf_counter() - t0, **vals)
        if i < args.controls and hasattr(model, "controls"):
            for kind, got in model.controls(outputs, s, cfg, csr, law_seed,
                                            graph, device):
                line(kind=kind, seed=seed, **got)
        del outputs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
