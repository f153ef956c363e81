"""The (p,q) samplers against the degree: exact against rejection.

Port of the JAX package's `benchmarks/pq_crossover.py`. On d-out-regular
graphs of `--nodes` vertices (`regular_graph`) at each degree of
`--degrees`, times one (p,q) walk of `--length` from every vertex by the
exact sampler (`ops.walk.node2vec_walks`: one Gumbel-max draw over the
padded neighbor row a hop), by rejection with CSR membership and by
rejection with dense membership (`node2vec_walks_rejection` with the
resident id rows and, the graphs being unweighted, uniform slot draws).
Each time is the best of `--reps` runs after an untimed one, the graph's
device views built before (host clock, the card synchronized). Prints one
JSON line a degree, the JAX script's keys, plus the sampler that
`ops.walk.select_pq_kernel` (the JAX package's rule, a TPU crossover)
picks there and the card's name and power limit. The rule is measured
here, not changed.

    python -m graphembedding_tpu_torch.benchmarks.pq_crossover
        [--nodes 20000] [--degrees 8 32 128 512] [--length 10] [--reps 3]
        [--p 0.25] [--q 4] [--out rows.jsonl] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from graphembedding_tpu_torch.benchmarks.million import card_line, sync
from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.ops.walk import (
    node2vec_walks,
    node2vec_walks_rejection,
    select_pq_kernel,
)


def regular_graph(V, d, seed=0) -> Graph:
    """A d-out-regular directed multigraph on V vertices: each vertex's d
    targets uniform (repeats allowed; for timing only)."""
    rng = np.random.default_rng(seed)
    src = np.repeat(np.arange(V, dtype=np.int64), d)
    dst = rng.integers(0, V, V * d).astype(np.int64)
    return Graph(src, dst, num_nodes=V, directed=True)


def best_seconds(fn, reps, device):
    """The best host seconds of `reps` runs of fn(seed) after an untimed
    one, each from a generator of its own seed."""
    best = float("inf")
    for r in range(reps + 1):
        gen = torch.Generator(device=device).manual_seed(100 + r)
        sync(device)
        t0 = time.perf_counter()
        fn(gen)
        sync(device)
        if r > 0:
            best = min(best, time.perf_counter() - t0)
    return best


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=20000)
    ap.add_argument("--length", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--degrees", type=int, nargs="+",
                    default=[8, 32, 128, 512])
    ap.add_argument("--p", type=float, default=0.25)
    ap.add_argument("--q", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Print one JSON line a degree (and write them to --out); returns
    them."""
    args = parse_args(argv)
    device = torch.device(args.device)
    card = card_line(device)
    p, q, length = args.p, args.q, args.length
    rows = []
    for d in args.degrees:
        g = regular_graph(args.nodes, d)
        dg = g.to(device)
        nbr, nbr_w = g.neighbor_matrix(device)
        accept, alias = g.alias_tables(device)
        starts = torch.arange(dg.num_nodes, dtype=torch.int64,
                              device=device)
        # as `simulate_walks` wires it: the envelope form keys on the row
        # weight sums (the degrees here)
        wsum = g.weight_sums(device)
        rej = dict(length=length, max_degree=max(dg.max_degree, 1),
                   wsum=wsum)
        t_exact = best_seconds(lambda gen: node2vec_walks(
            dg.degree, nbr, nbr_w, starts, p, q, length=length,
            generator=gen), args.reps, device)
        t_rej = best_seconds(lambda gen: node2vec_walks_rejection(
            dg.row_ptr, dg.col_idx, dg.degree, accept, alias, starts, p, q,
            generator=gen, **rej), args.reps, device)
        t_rej_dense = best_seconds(lambda gen: node2vec_walks_rejection(
            dg.row_ptr, dg.col_idx, dg.degree, accept, alias, starts, p, q,
            generator=gen, nbr=nbr, uniform_rows=True, **rej), args.reps,
            device)
        edges = starts.shape[0] * (length - 1)
        times = {"exact": t_exact, "rejection": t_rej,
                 "rejection_dense": t_rej_dense}
        row = {
            "max_degree": d,
            "dpad": ((max(g.max_degree, 1) + 127) // 128) * 128,
            "nodes": args.nodes, "p": p, "q": q,
            "exact_s": t_exact, "rejection_s": t_rej,
            "exact_edges_per_s": edges / t_exact,
            "rejection_edges_per_s": edges / t_rej,
            "rejection_dense_s": t_rej_dense,
            "rejection_dense_edges_per_s": edges / t_rej_dense,
            "winner": min(times, key=times.get),
            "nbr_matrix_mb": args.nodes * int(nbr.shape[1]) * 8 / 1e6,
            "select_pq_kernel": select_pq_kernel(args.nodes, g.max_degree),
            "card": card,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
        g.free_device()
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    return rows


if __name__ == "__main__":
    main()
