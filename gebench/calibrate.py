"""Readings that the check's limits are set from, at a cell's own size on
the card:

    python3 gebench/calibrate.py --workload <name> --seeds 12
        [--controls 3] [--base 5000]

For each of `--seeds` seeds, the program's fit (a model built and trained
through the public API on the cell's graph, as a window fit is) judged by
`check.judge`: the lower readings. For each of the first `--controls`
seeds, on that fit's corpus:
- the control: the reference in TF32 in the program's place, its tables
  against the float32 reference's (`table_err`);
- half of every step's walks left out, in the reference (`table_err`);
- a token altered where the walk produced it (`bad_hops`);
- the other walk's law in the corpus' place (`law_z`): uniform walks
  judged as (p,q) ones, or (p,q) walks (p = 0.25, q = 4) as uniform ones.
A fit whose state stays unchanged reads table_err 1 by its definition.
One JSON line a reading on standard output. Not run by the benchmark's
runs; needs the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def altered(walks, csr):
    """The corpus with one token changed to a node its predecessor has no
    edge to."""
    w = walks.clone()
    a = torch.tensor([int(w[0, 4])], device=w.device)
    for b in range(csr.V):
        if b != int(a) and int(csr.count(a, a * 0 + b)[0]) == 0:
            w[0, 5] = b
            return w
    raise ValueError("a node with an edge to every other")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--base", type=int, default=5000)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    from gebench import check, graphgen, harness, profiling
    from graphembedding_tpu_torch import DeepWalk, Graph, Node2Vec

    device, card = profiling.require_card(1)
    cell = harness.load_cell(ROOT, args.workload)
    cfg = cell.config

    def line(**kw):
        print(json.dumps(dict(cell=cell.name, card=card, **kw)), flush=True)

    for i in range(args.seeds):
        seed = args.base + i
        row_ptr, col = graphgen.synthetic_csr(
            cell.traffic["nodes"], cell.traffic["avg_degree"],
            cell.traffic["graph_seed"], device)
        graph = Graph.from_csr(row_ptr.cpu().numpy(), col.cpu().numpy(),
                               directed=False)
        csr = check.ref_walks.Csr(row_ptr, col)
        s = harness.derive_seed(seed, 2, 0)
        t0 = time.perf_counter()
        model = harness.build_model(graph, cfg, s, device)
        harness.train_model(model, cfg)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        walks, w_in, w_out = model.walks, model.w_in, model.w_out
        del model
        graph.free_device()
        t0 = time.perf_counter()
        vals = check.judge(walks, w_in, w_out, s, cfg, csr,
                           harness.derive_seed(seed, 4, 0))
        line(kind="program", seed=seed, fit_s=fit_s,
             check_s=time.perf_counter() - t0, **vals)
        if i >= args.controls:
            continue
        V = csr.V
        ref = check.reference_fit(walks, V, cfg, s)
        for kind, kw in (("control_tf32", dict(matmul="tf32")),
                         ("fault_half_batch", dict(drop_half=True))):
            other = check.reference_fit(walks, V, cfg, s, **kw)
            line(kind=kind, seed=seed,
                 table_err=check.table_err(other[0], other[1], ref))
            del other
        line(kind="fault_state_unchanged", seed=seed,
             table_err=check.table_err(ref[2], torch.zeros_like(ref[1]),
                                       ref))
        del ref
        line(kind="fault_token_altered", seed=seed,
             bad_hops=check.ref_walks.bad_hops(
                 altered(walks, csr), csr, cfg["num_walks"],
                 cfg["walk_length"]))
        kw = dict(walk_length=cfg["walk_length"],
                  num_walks=cfg["num_walks"], seed=s, device=device)
        wrong = (DeepWalk(graph, **kw) if cfg["walk"] == "node2vec"
                 else Node2Vec(graph, p=0.25, q=4, **kw)).walks
        graph.free_device()
        gen = torch.Generator(device=device)
        gen.manual_seed(harness.derive_seed(seed, 4, 0))
        line(kind="fault_wrong_law", seed=seed,
             law_z=check.ref_walks.law_z(wrong, csr, cfg["walk"],
                                         cfg.get("p", 1.0),
                                         cfg.get("q", 1.0),
                                         check.LAW_HOPS, gen))
        del wrong, walks, w_in, w_out
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
