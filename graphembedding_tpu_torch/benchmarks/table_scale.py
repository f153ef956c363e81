"""SGNS throughput against the vertex count, for each form of the cap.

Port of the JAX package's `benchmarks/table_scale.py`. For each V of
`--nodes` and each `cap_mode` (dense: the gradients summed into
[V, 2D + 1] and [V, D + 1] buffers, then the whole table scaled and added;
sparse: [V] occupancies, each gradient row pre-scaled and scattered into
the table), trains chunks of `sgns_block_chunk_cat` on a corpus of
`--walks-per-node` * V uniform random walks of L = 10 with the JAX
script's settings (D = 128, block_walks 4032, window 5, negative 5,
k_shared 64, neg_share_packs 4, update_cap 8, 64 steps a chunk): one warm
chunk (on the card it captures the chunk's graph), then `--reps` chunks
timed by CUDA events, their draws made inside the timed span as the JAX
chunk makes its own. Prints one JSON line a (V, cap_mode): trained pairs/s,
ms a chunk, and the chunk graphs the cache holds after it (count and MiB),
with the card's name and power limit. The graphs of one V are not released
before the next: the cache's byte budget (`train.chunk_graph.BUDGET_BYTES`)
bounds what the sweep holds.

    python -m graphembedding_tpu_torch.benchmarks.table_scale
        [--nodes 10000 100000 1000000] [--walks-per-node 5] [--reps 3]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from graphembedding_tpu_torch.benchmarks.million import card_line, sync
from graphembedding_tpu_torch.train import chunk_graph
from graphembedding_tpu_torch.train import skipgram as sg

L, D, S = 10, 128, 64
SETTINGS = dict(block_walks=4032, window=5, negative=5, neg_share_packs=4,
                update_cap=8.0)
K_SHARED = 64


class Span:
    """Seconds between start() and stop(): CUDA events on a card, the
    host's clock with a synchronize elsewhere."""

    def __init__(self, device):
        self.device = device

    def start(self):
        if self.device.type == "cuda":
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self):
        if self.device.type == "cuda":
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b) / 1e3
        sync(self.device)
        return time.perf_counter() - self.t0


def bench_one(V, NW, sparse, reps, device):
    """(pairs/s, s a chunk) of `reps` chunks after a warm one."""
    gen = torch.Generator(device=device).manual_seed(0)
    walks = torch.randint(0, V, (NW, L), generator=gen, device=device,
                          dtype=torch.int32)
    table = torch.as_tensor(
        sg.negative_table(sg.corpus_counts(walks, V)), device=device)
    w_cat = torch.cat([(torch.rand((V, D), generator=gen, device=device)
                        - 0.5) / D,
                       torch.zeros((V, D), device=device)], 1)
    geo = sg.block_geometry(NW, L, SETTINGS["block_walks"],
                            SETTINGS["neg_share_packs"])
    K = min(K_SHARED, V)

    def chunk(t0):
        eff = sg.window_draws(gen, (S, geo.G, geo.PL), SETTINGS["window"])
        negs = table[torch.randint(0, table.shape[0], (S, geo.G2, K),
                                   generator=gen, device=device)]
        return sg.sgns_block_chunk_cat(
            w_cat, walks, eff, negs, 0.025, 1e-4, t0, 1e7,
            sparse_cap=sparse, **SETTINGS)[2]

    chunk(0)  # warm: the capture
    span = Span(device)
    span.start()
    pairs = [chunk(r * S) for r in range(1, reps + 1)]
    seconds = span.stop()
    return float(torch.cat(pairs).sum()) / seconds, seconds / reps


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, nargs="+",
                    default=[10_000, 100_000, 1_000_000])
    ap.add_argument("--walks-per-node", type=float, default=5.0)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None):
    """Print one JSON line a (V, cap_mode); returns them."""
    args = parse_args(argv)
    device = torch.device(args.device)
    card = card_line(device)
    rows = []
    for V in args.nodes:
        NW = int(V * args.walks_per_node)
        for sparse in (False, True):
            rate, chunk_s = bench_one(V, NW, sparse, args.reps, device)
            row = {"bench": "sgns_table_scale", "nodes": V,
                   "cap_mode": "sparse" if sparse else "dense",
                   "pairs_per_s": rate, "chunk_ms": chunk_s * 1e3,
                   "held_graphs": len(chunk_graph.held(device)),
                   "held_mib": chunk_graph.held_bytes(device) / 2**20,
                   "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
