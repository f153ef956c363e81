"""Row gather by one bulk copy per row (K5) against the plain gather and K3.

Port of the JAX package's `benchmarks/dma_gather.py`, which asked whether
hand-issued row DMAs beat XLA's row gather on the TPU. Here it gathers N
random rows of a [V, W] float32 table on the card three ways:

  plain         out = table[ids]            (in place of XLA's take)
  index_select  torch.index_select(table, 0, ids): the library call
  k3            gather_rows: a warp per row, 16-byte loads
  k5_b{B}       dma_gather_rows: B-row stages on a ring, one cp.async.bulk
                a row, one bulk store a stage, a persistent grid

Each variant prints one JSON line: ns_per_row (best of --reps timed calls,
CUDA events, new ids each call, after one untimed call), whether every
call's output equals table[ids], the mean number of distinct rows the
timed calls gathered, and the card's name and power limit. Every line but
index_select's also gives `turns_ms` and `index_select_ms`: the median
device ms a call of the variant and of `index_select` on the same ids,
timed in turns (`common.turns_ms`); K5's give its launch plan (ring
stages, grid, shared bytes a block). A `copy` line times a contiguous
copy of the same [N, W] bytes (the card's ceiling for this traffic
without random rows) in turns with `index_select`.

Variants, each timed in turns with the checkout's K5 at every B and
checked bit for bit against it, one JSON line each:
  --plans BPS:S[:G] ...  the checkout's kernel with at most BPS blocks an
                         SM and S ring stages (`ops/rows.py::dma_gather_plan`),
                         on a grid of G blocks where G is given
  --source FILE ...      a text variant of csrc/dma_gather.cu with the
                         same C entry point
  --legacy-source FILE   a source with the entry point of the design
                         before the ring (no plan arguments: a block per
                         B ids)

    python -m graphembedding_tpu_torch.benchmarks.dma_gather \
        [--rows 1048576] [--width 256] [--gather 65536] [--reps 5] \
        [--block-rows 8 16 32] [--plans 1:8 ...] \
        [--source f.cu ...] [--legacy-source f.cu ...]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os

import torch

from graphembedding_tpu_torch.benchmarks.common import (
    best_seconds,
    require_card,
    turns_ms,
)
from graphembedding_tpu_torch.kernels import build as kb
from graphembedding_tpu_torch.ops.rows import (
    dma_gather_launch,
    dma_gather_plan,
    dma_gather_rows,
    dma_gather_rows_plain,
    gather_rows,
    sm_count,
)

_LEGACY_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--gather", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--block-rows", type=int, nargs="+", default=[8, 16, 32])
    ap.add_argument("--plans", nargs="*", default=[])
    ap.add_argument("--source", nargs="*", default=[])
    ap.add_argument("--legacy-source", nargs="*", default=[])
    return ap.parse_args(argv)


def source_variant(path, legacy):
    """fn(table, ids, B) -> out through a library built from the source at
    path (entry point `ge_dma_gather_rows`)."""
    with open(path) as f:
        dll, _ = kb.build_text(f.read(), "dma_variants",
                               os.path.basename(path).replace(".", "_"))
    entry = dll.ge_dma_gather_rows
    if legacy:
        entry.argtypes = _LEGACY_ARGS

    def run(table, ids, B):
        n, w = ids.shape[0], table.shape[1]
        out = torch.empty((n, w), dtype=torch.float32, device=table.device)
        plan = () if legacy else dma_gather_plan(
            n, w, B, sm_count(table.device.index))
        kb.check(entry(table.device.index, table.data_ptr(), table.shape[0],
                       ids.data_ptr(), n, w, B, *plan, out.data_ptr(),
                       kb.stream_ptr(table.device)), path)
        return out
    return run


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

    ids = make_ids(1)
    ids_l = ids.long()

    def index_select():
        return torch.index_select(table, 0, ids_l)

    def time_fn(fn, tag, **extra):
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
               "ns_per_row": best / N * 1e9, "equal_to_plain": same}
        if tag != "index_select":
            row["turns_ms"], row["index_select_ms"] = turns_ms(
                lambda: fn(table, ids), index_select)
        row.update(extra, card=card)
        print(json.dumps(row), flush=True)
        return row

    rows = [time_fn(dma_gather_rows_plain, "plain"),
            time_fn(lambda t, i: torch.index_select(t, 0, i), "index_select"),
            time_fn(gather_rows, "k3")]
    # yardstick: a contiguous copy of the bytes the gathers move
    src, dst = torch.randn((2, N, W), device=dev)
    row = {"variant": "copy", "rows_gathered": N, "width": W, "card": card}
    row["turns_ms"], row["index_select_ms"] = turns_ms(
        lambda: dst.copy_(src), index_select)
    print(json.dumps(row), flush=True)
    rows.append(row)
    sms = sm_count(table.device.index)
    for B in args.block_rows:
        rows.append(time_fn(functools.partial(dma_gather_rows, block_rows=B),
                            f"k5_b{B}", plan=dma_gather_plan(N, W, B, sms)))

    plans = [tuple(int(x) for x in p.split(":")) for p in args.plans]
    variants = [(f"plan {':'.join(map(str, p))}", functools.partial(
        _with_plan, p=p, sms=sms), p) for p in plans]
    variants += [(f"source {p}", source_variant(p, False), None)
                 for p in args.source]
    variants += [(f"legacy {p}", source_variant(p, True), None)
                 for p in args.legacy_source]
    for name, run, p in variants:
        for B in args.block_rows:
            want = dma_gather_rows(table, ids, B)
            row = {"variant": name, "block_rows": B,
                   "equal_to_checkout": torch.equal(run(table, ids, B), want)}
            if p is not None:
                row["plan"] = _plan(N, W, B, sms, p)
            row["ms"], row["checkout_ms"] = turns_ms(
                lambda: run(table, ids, B),
                lambda: dma_gather_rows(table, ids, B))
            row["card"] = card
            print(json.dumps(row), flush=True)
            rows.append(row)
    return rows


def _plan(n, w, B, sms, p):
    """dma_gather_plan with at most p[0] blocks an SM and p[1] stages, and
    a grid of p[2] blocks where p has a third entry."""
    stages, grid, smem = dma_gather_plan(n, w, B, sms, blocks_per_sm=p[0],
                                         max_stages=p[1])
    return stages, (min(p[2], n // B) if len(p) > 2 else grid), smem


def _with_plan(table, ids, B, p, sms):
    """The checkout's K5 with the plan `_plan` makes of p."""
    return dma_gather_launch(table, ids, B,
                             _plan(ids.shape[0], table.shape[1], B, sms, p))


if __name__ == "__main__":
    main()
