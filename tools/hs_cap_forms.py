"""How far hierarchical softmax's two cap forms drift apart over a fit, in
the JAX package and in the port, on the CPU.

Both packages' `HSTrainer` fit the same corpus (80 walks of 10 a node on a
synthetic Wiki-like graph, D = 128, window 5) once with
`cap_mode='sparse'` and once with `cap_mode='dense'`. The forms compute the
same update and add it in another order, so the tables agree to float32
rounding after a step; over a fit the differences grow. Prints one JSON
line a (package, table): the max abs difference of the two fits' tables
and its largest share of the bound atol + rtol * |dense| at (1e-4, 1e-6)
and at (1e-3, 1e-5).

    JAX_PLATFORMS=cpu python tools/hs_cap_forms.py [--nodes 300]
        [--epochs 3] [--seed 7]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=300)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import torch

    from graphembedding_tpu.train.hsoftmax import HSTrainer as JaxHS
    from graphembedding_tpu_torch import DeepWalk
    from graphembedding_tpu_torch.data import datasets as tds
    from graphembedding_tpu_torch.train.hsoftmax import HSTrainer

    torch.set_num_threads(2)
    ds = tds.synthetic_wiki(num_nodes=args.nodes, seed=args.seed)
    walks = DeepWalk(ds.graph, walk_length=10, num_walks=80,
                     device="cpu").walks
    V = args.nodes
    fits = {
        "jax": lambda mode: JaxHS(embed_size=128, window=5,
                                  epochs=args.epochs, cap_mode=mode).fit(
            walks.numpy(), V),
        "port": lambda mode: HSTrainer(embed_size=128, window=5,
                                       epochs=args.epochs,
                                       cap_mode=mode).fit(walks, V),
    }
    rows = []
    for pkg, fit in fits.items():
        sparse, dense = fit("sparse"), fit("dense")
        for name, a, b in zip(("w_in", "w_tree"), sparse, dense):
            a, b = np.asarray(a), np.asarray(b)
            err = np.abs(a - b)
            row = {"package": pkg, "table": name, "steps": len(
                np.asarray(sparse[2])), "max_abs_err": float(err.max()),
                "share_1e-4_1e-6": float((err / (1e-6 + 1e-4 * np.abs(b)))
                                         .max()),
                "share_1e-3_1e-5": float((err / (1e-5 + 1e-3 * np.abs(b)))
                                         .max())}
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()
