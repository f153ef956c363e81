"""Row gather by one bulk copy per row (K5) against the plain gather and K3.

Port of the JAX package's `benchmarks/dma_gather.py`, which asked whether
hand-issued row DMAs beat XLA's row gather on the TPU. Here it gathers N
random rows of a [V, W] float32 table on the card three ways:

  plain         out = table[ids]            (in place of XLA's take)
  index_select  torch.index_select(table, 0, ids): the library call
  k3            gather_rows: a warp per row, 16-byte loads
  k5_b{B}       dma_gather_rows: a block per B ids, one cp.async.bulk a row

Each variant prints one JSON line: ns_per_row (best of --reps timed calls,
CUDA events, new ids each call, after one untimed call), whether every
call's output equals table[ids], the mean number of distinct rows the
timed calls gathered, and the card's name and power limit.

    python -m graphembedding_tpu_torch.benchmarks.dma_gather \
        [--rows 1048576] [--width 256] [--gather 65536] [--reps 5] \
        [--block-rows 8 16 32]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import functools
import json

import torch

from graphembedding_tpu_torch.benchmarks.common import (
    best_seconds,
    require_card,
)
from graphembedding_tpu_torch.ops.rows import (
    dma_gather_rows,
    dma_gather_rows_plain,
    gather_rows,
)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--gather", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--block-rows", type=int, nargs="+", default=[8, 16, 32])
    return ap.parse_args(argv)


def main(argv=None):
    """Run every variant; returns their JSON records."""
    args = parse_args(argv)
    dev, card = require_card()
    V, W, N = args.rows, args.width, args.gather
    table = torch.randn((V, W), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)

    def make_ids(r):
        return torch.randint(0, V, (N,), generator=torch.Generator(
            device=dev).manual_seed(10 + r), device=dev, dtype=torch.int32)

    def time_fn(fn, tag):
        equal = []

        def call(ids):
            out = fn(table, ids)
            equal.append((out, ids))

        best = best_seconds(call, make_ids, args.reps)
        same = all(torch.equal(out, dma_gather_rows_plain(table, ids))
                   for out, ids in equal)
        unique = sum(ids.unique().numel() for _, ids in equal[1:]) / (
            len(equal) - 1)
        row = {"variant": tag, "rows_gathered": N, "width": W,
               "table_rows": V, "unique_rows": unique, "best_s": best,
               "ns_per_row": best / N * 1e9, "equal_to_plain": same,
               "card": card}
        print(json.dumps(row), flush=True)
        return row

    rows = [time_fn(dma_gather_rows_plain, "plain"),
            time_fn(lambda t, i: torch.index_select(t, 0, i), "index_select"),
            time_fn(gather_rows, "k3")]
    for B in args.block_rows:
        rows.append(time_fn(functools.partial(dma_gather_rows, block_rows=B),
                            f"k5_b{B}"))
    return rows


if __name__ == "__main__":
    main()
