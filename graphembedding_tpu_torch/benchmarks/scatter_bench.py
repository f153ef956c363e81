"""The port's row scatter-adds and gather against their plain versions.

Port of the JAX package's `benchmarks/pallas_scatter_bench.py`, at its
shapes (C = 256 columns, N = 45,696 rows a call):

- `--mode rmw`: K2 `scatter_add_rows` (one launch: it groups the ids by
  hand, then makes one read-modify-write per unique row) against the
  plain `index_add_`, at V = 125k, 500k and 1M table rows;
- `--mode matmul`: K4 `scatter_add_small` (by its plan rule) against the
  plain `index_add_` and against K2, and K3 `gather_rows` against the
  plain `index_select`, at V = 2405 and 10,312;
- `--mode plans`: K4 by each plan (`scan`, `group`), K2 and a bare
  `index_add_` on the kept ids, each the median device time of one call
  on one id set (CUDA events around calls queued while the card is held),
  over the ids' kind, V (`--v`, default 131, 2405, 10,312, 16,384 and
  24,576: the group plan only up to SMALL_V_ROWS) and N (`--rows`,
  default 1,024 to 70,560), all bit-checked against each other. These
  times are what `ops/rows.py::small_plan` and `SMALL_V_ROWS` rest on.

`--ids uniform` draws ids uniformly in [0, V); `--ids hs` takes the
Huffman paths of the hierarchical-softmax tree scatter: a Huffman tree
over V + 1 nodes with Zipf-like counts (V inner rows, the root first),
tokens drawn by those counts, each token's root-to-leaf path padded with
-1 to the tree's depth (N rounded down to whole paths).

In the rmw and matmul modes each timed call runs `window` = 16
operations on new ids (drawn before the call); the best of `reps` = 4
calls, after one untimed call, gives ns_per_row = seconds / (window *
N). Each measurement prints one JSON line to stdout with the card's name
and power limit, and the kernels' agreement with their plain versions on
one operation. `--quick` runs V = 1M (rmw) and V = 2405 (matmul) only;
`--v`, `--c` and `--rows` override the shapes.

    python -m graphembedding_tpu_torch.benchmarks.scatter_bench \
        [--quick] [--mode all|rmw|matmul|plans] [--ids uniform|hs]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json

import torch

import numpy as np

from graphembedding_tpu_torch.benchmarks.common import (
    best_seconds,
    median_ms,
    require_card,
)
from graphembedding_tpu_torch.ops.rows import (
    SMALL_V_ROWS,
    gather_rows,
    gather_rows_plain,
    scatter_add_rows,
    scatter_add_rows_plain,
    scatter_add_small,
    small_plan,
)

WINDOW, REPS = 16, 4


def hs_path_ids(v, n_rows, seed):
    """[n, ] int32 ids of the hierarchical-softmax tree scatter into v
    rows: the -1-padded Huffman paths (depth T) of n_rows // T tokens
    drawn by Zipf-like counts over v + 1 nodes."""
    from graphembedding_tpu_torch.train.hsoftmax import build_huffman

    counts = np.floor(1e4 / np.arange(1, v + 2))
    points, _, depth = build_huffman(counts)
    tok = np.random.default_rng(seed).choice(
        v + 1, max(1, n_rows // depth), p=counts / counts.sum())
    return points[tok].reshape(-1).astype(np.int32)


def _case(dev, v, c, n_rows, ids="uniform"):
    gen = torch.Generator(device=dev).manual_seed(0)
    if ids == "hs":
        n_rows = hs_path_ids(v, n_rows, 0).size
    table = torch.rand((v, c), generator=gen, device=dev)
    grads = torch.rand((n_rows, c), generator=gen, device=dev)

    def make_ids(r):
        if ids == "hs":
            return torch.from_numpy(np.stack(
                [hs_path_ids(v, n_rows, 100 + WINDOW * r + i)
                 for i in range(WINDOW)])).to(dev)
        return torch.randint(0, v, (WINDOW, n_rows), generator=torch.
                             Generator(device=dev).manual_seed(100 + r),
                             device=dev, dtype=torch.int32)

    return table, grads, make_ids


def _ns_per_row(op, make_ids, n_rows):
    def run(ids):
        for i in range(WINDOW):
            op(ids[i])

    return best_seconds(run, make_ids, REPS) / (WINDOW * n_rows) * 1e9


def measure_scatter(dev, v, c=256, n_rows=45_696):
    """K2 against index_add_ at table size v."""
    table, grads, make_ids = _case(dev, v, c, n_rows)
    ids0 = make_ids(0)[0]
    got = scatter_add_rows(table.clone(), ids0, grads)
    want = scatter_add_rows_plain(table.clone(), ids0, grads)
    out = {"v": v, "c": c, "rows": n_rows,
           "k2_max_abs_err": float((got - want).abs().max())}
    for name, fn in (("plain", scatter_add_rows_plain),
                     ("k2", scatter_add_rows)):
        out[f"{name}_ns_per_row"] = _ns_per_row(
            lambda ids, fn=fn: fn(table, ids, grads), make_ids, n_rows)
    return out


def measure_matmul(dev, v, c=256, n_rows=45_696, ids="uniform"):
    """K4 against index_add_ and K2, K3 against index_select, at table
    size v. K4 and K2 both sum each row in index order from its table
    value, so they agree bit for bit."""
    table, grads, make_ids = _case(dev, v, c, n_rows, ids)
    n_rows = grads.shape[0]
    ids0 = make_ids(0)[0]
    k4 = scatter_add_small(table.clone(), ids0, grads)
    k2 = scatter_add_rows(table.clone(), ids0, grads)
    plain = scatter_add_rows_plain(table.clone(), ids0, grads)
    out = {"v": v, "c": c, "rows": n_rows, "ids": ids,
           "k4_plan": small_plan(n_rows, v),
           "k4_equal_k2": torch.equal(k4, k2),
           "k4_max_abs_err": float((k4 - plain).abs().max()),
           "k3_equal": torch.equal(gather_rows(table, ids0.clamp(min=0)),
                                   gather_rows_plain(table,
                                                     ids0.clamp(min=0)))}
    for name, fn in (("plain_gather", gather_rows_plain),
                     ("k3_gather", gather_rows)):
        out[f"{name}_ns_per_row"] = _ns_per_row(
            lambda i, fn=fn: fn(table, i.clamp(min=0)), make_ids, n_rows)
    for name, fn in (("plain_scatter", scatter_add_rows_plain),
                     ("k4_scatter", scatter_add_small),
                     ("k2_scatter", scatter_add_rows)):
        out[f"{name}_ns_per_row"] = _ns_per_row(
            lambda i, fn=fn: fn(table, i, grads), make_ids, n_rows)
    return out


def measure_plans(dev, v, c=128, n_rows=45_696, ids="uniform"):
    """K4 by each plan, K2 and index_add_ on one id set: median device ms
    a call, and whether the kernels' sums are bit-equal."""
    table, grads, make_ids = _case(dev, v, c, n_rows, ids)
    n_rows = grads.shape[0]
    i = make_ids(0)[0]
    keep = (i >= 0) & (i < v)
    i_kept, g_kept = i[keep].long(), grads[keep].contiguous()
    plans = ("scan", "group") if v <= SMALL_V_ROWS else ("scan",)
    sums = [scatter_add_small(table.clone(), i, grads, plan=p)
            for p in plans] + [scatter_add_rows(table.clone(), i, grads)]
    out = {"v": v, "c": c, "rows": n_rows, "ids": ids,
           "kept": int(keep.sum()), "longest_run": int(torch.bincount(
               i_kept, minlength=v).max()) if len(i_kept) else 0,
           "plan": small_plan(n_rows, v),
           "equal": all(torch.equal(sums[0], x) for x in sums[1:])}
    buf = table.clone()
    for p in plans:
        out[f"k4_{p}_ms"] = median_ms(
            lambda p=p: scatter_add_small(buf, i, grads, plan=p))
    out["k2_ms"] = median_ms(lambda: scatter_add_rows(buf, i, grads))
    out["index_add_ms"] = median_ms(
        lambda: buf.index_add_(0, i_kept, g_kept))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--mode", default="all",
                   choices=["all", "rmw", "matmul", "plans"])
    p.add_argument("--ids", default="uniform", choices=["uniform", "hs"])
    p.add_argument("--v", type=int, nargs="+", default=None,
                   help="table sizes in place of the mode's own")
    p.add_argument("--c", type=int, default=None,
                   help="columns (default 256; 128 in the plans mode)")
    p.add_argument("--rows", type=int, nargs="+", default=None,
                   help="ids a call (default 45,696; a sweep in the plans "
                        "mode)")
    return p.parse_args(argv)


def main(argv=None):
    """Run the chosen measurements; returns their JSON records."""
    args = parse_args(argv)
    dev, card = require_card()
    plan = []
    if args.mode in ("all", "rmw"):
        vs = [1_000_000] if args.quick else [125_000, 500_000, 1_000_000]
        plan += [(measure_scatter, v) for v in args.v or vs]
    if args.mode in ("all", "matmul"):
        vs = [2405] if args.quick else [2405, 10_312]
        plan += [(measure_matmul, v) for v in args.v or vs]
    if args.mode == "plans":
        vs = args.v or [131, 2405, 10_312, 16_384, 24_576]
        ns = args.rows or [1024, 6144, 16_384, 45_696, 70_560]
        plan = [(measure_plans, v, n) for v in vs for n in ns]
    else:
        plan = [(fn, v, (args.rows or [45_696])[0]) for fn, v in plan]
    c = args.c or (128 if args.mode == "plans" else 256)
    results = []
    for fn, v, n in plan:
        kw = {} if fn is measure_scatter else {"ids": args.ids}
        r = dict(fn(dev, v, c=c, n_rows=n, **kw), card=card)
        print(json.dumps(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
