"""DeepWalk at a million nodes on one card: a synthetic graph, its walks,
one epoch of SGNS.

Port of the JAX package's `benchmarks/million.py`. Builds a random graph
at the requested vertex count on the device (`synthetic_graph`, or
`clustered_graph` with `--clustered`), walks every vertex `--num-walks`
times, frees the graph's device views, then trains SGNS (D = 128, the
trainer's defaults) for `--epochs`, once cold (the chunk graphs
captured) and once warm. Prints one JSON line a stage, the card's name
and power limit on each:

- `million_build`: nodes, directed edge entries, seconds;
- `million_walks`: walkers, walked edges/s of the warm walk, warm and
  cold seconds;
- `million_train`: cap_mode (the form `cap_mode='auto'` picked: the
  sparse cap from 2^16 nodes on), warm and cold seconds, trained pairs/s
  of the warm train, the mean loss of the last 20 steps, the warm train's
  device ms and busy share (torch.profiler), and the reserved MiB after
  the trains.

    python -m graphembedding_tpu_torch.benchmarks.million [--nodes 1000000]
        [--avg-degree 10] [--num-walks 5] [--walk-length 10] [--epochs 1]
        [--clustered] [--device cuda]

Runs on the card (`--device cpu` runs the same stages on the CPU, with no
device profile). The JAX script's `--blocked` (`shuffle_mode='block'`) is
not ported: the block-preserving shuffle worked around the TPU's scatter
and is not a trainer option of the port.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.ops.walk import simulate_walks
from graphembedding_tpu_torch.train.skipgram import (
    SkipGramConfig,
    SkipGramTrainer,
    sparse_cap_for,
)


def _undirected_csr(src, dst, V) -> Graph:
    """The graph of edges (src, dst) (int64 tensors, both on one device)
    with every loop moved to (d + 1) % V, in both directions, sorted by
    (source, target) into a CSR that `Graph.from_csr` adopts."""
    dst = torch.where(src == dst, (dst + 1) % V, dst)
    s2 = torch.cat([src, dst])
    d2 = torch.cat([dst, src])
    # one sort of source * V + target: the two-key lexicographic order
    key = torch.sort(s2 * V + d2).values
    s2, d2 = key // V, key % V
    row_ptr = torch.zeros(V + 1, dtype=torch.int64, device=src.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(s2, minlength=V), 0)
    return Graph.from_csr(row_ptr.cpu().numpy(),
                          d2.to(torch.int32).cpu().numpy(), directed=False)


def random_edge_count(V, avg_degree) -> int:
    """The random edges added to the ring: V * max(avg_degree - 2, 1) //
    2, as the JAX package's generators add."""
    return V * max(avg_degree - 2, 1) // 2


def synthetic_graph(V: int, avg_degree: int, seed: int = 0,
                    device="cuda") -> Graph:
    """A ring (connectivity) plus `random_edge_count` random edges with a
    mild hub skew: sources uniform, targets floor(U^2 * V), so low ids
    gather the edges (heavy-tailed degrees). Generated and sorted on
    `device` from a generator seeded with `seed`: the JAX package's graph
    in distribution, not in value (its random stream is not
    reproduced)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_rand = random_edge_count(V, avg_degree)
    ring = torch.arange(V, dtype=torch.int64, device=device)
    src = torch.randint(0, V, (n_rand,), generator=gen, device=device)
    u = torch.rand(n_rand, generator=gen, device=device)
    dst = (u ** 2 * V).to(torch.int64) % V
    return _undirected_csr(torch.cat([ring, src]),
                           torch.cat([(ring + 1) % V, dst]), V)


def clustered_graph(V: int, avg_degree: int, seed: int = 0,
                    spread: int = 4096, device="cuda") -> Graph:
    """A small-world graph with vertex locality: the ring plus
    `random_edge_count` random edges whose targets lie within `spread` ids
    of their sources (offsets floor(U^2 * spread) + 1, either sign), 2% of
    them rewired to a uniform target. The same edge count and construction
    as `synthetic_graph`, in distribution the JAX package's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_rand = random_edge_count(V, avg_degree)
    ring = torch.arange(V, dtype=torch.int64, device=device)
    src = torch.randint(0, V, (n_rand,), generator=gen, device=device)
    u = torch.rand(n_rand, generator=gen, device=device)
    off = (u ** 2 * spread).to(torch.int64) + 1
    sign = torch.randint(0, 2, (n_rand,), generator=gen,
                         device=device) * 2 - 1
    dst = (src + sign * off) % V
    far = torch.rand(n_rand, generator=gen, device=device) < 0.02
    dst = torch.where(far, torch.randint(0, V, (n_rand,), generator=gen,
                                         device=device), dst)
    return _undirected_csr(torch.cat([ring, src]),
                           torch.cat([(ring + 1) % V, dst]), V)


def card_line(device) -> str:
    """The card's 'name, power limit' (nvidia-smi), or 'cpu'."""
    if device.type != "cuda":
        return "cpu"
    from graphembedding_tpu_torch.benchmarks.common import require_card

    return require_card()[1]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device):
    """(fn(), host seconds) with the device synchronized on both sides."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def profile(fn, seconds, device):
    """(device ms, busy share) of one call of fn that took `seconds` warm
    (torch.profiler); (None, None) off a card."""
    if device.type != "cuda":
        return None, None
    from graphembedding_tpu_torch.benchmarks.train_profile import (
        breakdown, device_events)

    prof = breakdown(device_events(fn), 1)
    return prof["device_ms"], prof["busy_ms"] / 1e3 / seconds


def reserved_mib(device):
    if device.type != "cuda":
        return None
    return torch.cuda.memory_reserved(device) / 2**20


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=1_000_000)
    ap.add_argument("--avg-degree", type=int, default=10)
    ap.add_argument("--num-walks", type=int, default=5)
    ap.add_argument("--walk-length", type=int, default=10)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--clustered", action="store_true",
                    help="locality-bearing small-world graph")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Run the three stages and print their JSON lines; returns them."""
    args = parse_args(argv)
    device = torch.device(args.device)
    card = card_line(device)
    V = args.nodes
    rows = []

    def emit(row):
        row["card"] = card
        rows.append(row)
        print(json.dumps(row), flush=True)

    make = clustered_graph if args.clustered else synthetic_graph
    g, t_build = timed(lambda: make(V, args.avg_degree, device=device),
                       device)
    emit({"bench": "million_build", "nodes": V, "edges": g.num_edges,
          "seconds": t_build})

    def walk(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return simulate_walks(g, args.num_walks, args.walk_length,
                              generator=gen)

    _, t_cold = timed(lambda: walk(0), device)  # builds the device CSR
    walks, t_walk = timed(lambda: walk(1), device)
    edges = walks.shape[0] * (walks.shape[1] - 1)
    emit({"bench": "million_walks", "nodes": V, "walkers": walks.shape[0],
          "walked_edges_per_s": edges / t_walk, "seconds_warm": t_walk,
          "seconds_cold": t_cold})

    # the fit reads no view of the graph: its device CSR goes
    g.free_device()
    cfg = SkipGramConfig(epochs=args.epochs)
    trainer = SkipGramTrainer(cfg)
    _, t_cold = timed(lambda: trainer.fit(walks, V), device)
    (_, losses), t_train = timed(lambda: trainer.fit(walks, V), device)
    device_ms, busy = profile(lambda: trainer.fit(walks, V), t_train, device)
    emit({"bench": "million_train", "nodes": V, "epochs": args.epochs,
          "cap_mode": ("sparse" if sparse_cap_for(cfg.cap_mode, V)
                       else "dense"),
          "seconds_warm": t_train, "seconds_cold": t_cold,
          "pairs_per_s": trainer.trained_pairs_ / t_train,
          "mean_loss_tail": float(np.asarray(losses[-20:].cpu()).mean()),
          "device_ms": device_ms, "busy_share": busy,
          "reserved_mib": reserved_mib(device)})
    return rows


if __name__ == "__main__":
    main()
