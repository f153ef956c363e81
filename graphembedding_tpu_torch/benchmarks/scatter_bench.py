"""The port's row scatter-adds and gather against their plain versions.

Port of the JAX package's `benchmarks/pallas_scatter_bench.py`, at its
shapes (C = 256 columns, N = 45,696 rows a call):

- `--mode rmw`: K2 `scatter_add_rows` (one launch: it groups the ids by
  hand, then makes one read-modify-write per unique row) against the
  plain `index_add_`, at V = 125k, 500k and 1M table rows;
- `--mode matmul`: K4 `scatter_add_small` (a block per tile of table
  rows) against the plain `index_add_` and against K2, and K3
  `gather_rows` against the plain `index_select`, at V = 2405 and 10,312.
  The K4-to-K2 times are what `models/line.py::SMALL_V_ROWS` rests on.

Each timed call runs `window` = 16 operations on new ids (drawn before the
call); the best of `reps` = 4 calls, after one untimed call, gives
ns_per_row = seconds / (window * N). Each measurement prints one JSON line
to stdout with the card's name and power limit, and the kernels' agreement
with their plain versions on one operation. `--quick` runs V = 1M (rmw)
and V = 2405 (matmul) only; `--v`, `--c` and `--rows` override the shapes.

    python -m graphembedding_tpu_torch.benchmarks.scatter_bench \
        [--quick] [--mode all|rmw|matmul]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json

import torch

from graphembedding_tpu_torch.benchmarks.common import (
    best_seconds,
    require_card,
)
from graphembedding_tpu_torch.ops.rows import (
    gather_rows,
    gather_rows_plain,
    scatter_add_rows,
    scatter_add_rows_plain,
    scatter_add_small,
)

WINDOW, REPS = 16, 4


def _case(dev, v, c, n_rows):
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.rand((v, c), generator=gen, device=dev)
    grads = torch.rand((n_rows, c), generator=gen, device=dev)

    def make_ids(r):
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


def measure_matmul(dev, v, c=256, n_rows=45_696):
    """K4 against index_add_ and K2, K3 against index_select, at table
    size v. K4 and K2 both sum each row in index order from its table
    value, so they agree bit for bit."""
    table, grads, make_ids = _case(dev, v, c, n_rows)
    ids0 = make_ids(0)[0]
    k4 = scatter_add_small(table.clone(), ids0, grads)
    k2 = scatter_add_rows(table.clone(), ids0, grads)
    plain = scatter_add_rows_plain(table.clone(), ids0, grads)
    out = {"v": v, "c": c, "rows": n_rows,
           "k4_equal_k2": torch.equal(k4, k2),
           "k4_max_abs_err": float((k4 - plain).abs().max()),
           "k3_equal": torch.equal(gather_rows(table, ids0),
                                   gather_rows_plain(table, ids0))}
    for name, fn in (("plain_gather", gather_rows_plain),
                     ("k3_gather", gather_rows)):
        out[f"{name}_ns_per_row"] = _ns_per_row(
            lambda ids, fn=fn: fn(table, ids), make_ids, n_rows)
    for name, fn in (("plain_scatter", scatter_add_rows_plain),
                     ("k4_scatter", scatter_add_small),
                     ("k2_scatter", scatter_add_rows)):
        out[f"{name}_ns_per_row"] = _ns_per_row(
            lambda ids, fn=fn: fn(table, ids, grads), make_ids, n_rows)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--mode", default="all", choices=["all", "rmw", "matmul"])
    p.add_argument("--v", type=int, nargs="+", default=None,
                   help="table sizes in place of the mode's own")
    p.add_argument("--c", type=int, default=256)
    p.add_argument("--rows", type=int, default=45_696)
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
    results = []
    for fn, v in plan:
        r = dict(fn(dev, v, c=args.c, n_rows=args.rows), card=card)
        print(json.dumps(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
