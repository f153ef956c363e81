"""Shared example plumbing: the command line, evaluation and the t-SNE plot.

Counterpart of the JAX package's `examples/common.py`, plus `--device`.
`--mesh DATA[xMODEL]` trains over a mesh of the ranks that `torchrun`
starts, one process a rank:

    torchrun --nproc-per-node 2 -m graphembedding_tpu_torch.examples.\
deepwalk_wiki --mesh 2
"""

from __future__ import annotations

import argparse
import json
import os
import time

from graphembedding_tpu_torch.data import load_dataset
from graphembedding_tpu_torch.eval.classify import Classifier


def make_parser(name: str, dataset_default: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=name)
    p.add_argument("--dataset", default=dataset_default,
                   help="dataset name (wiki, flight-brazil, blogcatalog)")
    p.add_argument("--embed-size", type=int, default=128)
    p.add_argument("--train-frac", type=float, default=0.8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--plot", default=None, metavar="PNG",
                   help="write a t-SNE scatter to this file (needs "
                        "matplotlib and scikit-learn)")
    p.add_argument("--json", action="store_true",
                   help="print results as one JSON line")
    p.add_argument("--trainer", default="block",
                   choices=("block", "dense"),
                   help="'dense' = closed-form expected-SGNS "
                        "(train/dense.py; small graphs)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: the CUDA card; "
                        "'cpu' runs on the CPU)")
    p.add_argument("--mesh", default=None, metavar="DATA[xMODEL]",
                   help="train over a mesh of the ranks torchrun started, "
                        "e.g. '2' or '2x2' (data x model axes; their product "
                        "is the world size)")
    return p


# what torchrun sets in each rank's environment
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def mesh_from_args(args):
    """None, or the (data, model) mesh of --mesh over the ranks torchrun
    started: joins the group from their environment (NCCL for a CUDA
    device, each rank on the card of its LOCAL_RANK; gloo for the CPU).
    Raises without that environment, or when the shape is not the world
    size."""
    if not getattr(args, "mesh", None):
        return None
    import torch
    import torch.distributed as dist

    from graphembedding_tpu_torch.parallel.mesh import (
        init_distributed,
        make_mesh,
    )

    missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--mesh needs the environment torchrun sets "
                           f"(missing {', '.join(missing)}); run under "
                           f"torchrun --nproc-per-node N")
    parts = str(args.mesh).lower().split("x")
    shape = (int(parts[0]), int(parts[1]) if len(parts) > 1 else 1)
    world = int(os.environ["WORLD_SIZE"])
    if shape[0] * shape[1] != world:
        raise ValueError(f"--mesh {args.mesh} is {shape[0] * shape[1]} "
                         f"ranks, torchrun started {world}")
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        args.device = str(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_distributed(int(os.environ["RANK"]), world,
                         "nccl" if device.type == "cuda" else "gloo",
                         "env://")
    return make_mesh(shape, device=device)


def evaluate_embeddings(embeddings, ds, train_frac=0.8, seed=0):
    clf = Classifier(embeddings)
    return clf.split_train_evaluate(ds.X, ds.Y, train_frac, seed=seed)


def plot_embeddings(embeddings, ds, path):
    """t-SNE scatter colored by (first) label, the reference's plot."""
    try:
        import matplotlib
        from sklearn.manifold import TSNE
    except ImportError as e:
        raise ImportError(
            f"--plot needs matplotlib and scikit-learn, which this Python "
            f"lacks ({e}); install them or drop --plot") from e
    import numpy as np

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    X = ds.X
    emb = np.asarray([embeddings[x] for x in X])
    pos = TSNE(n_components=2, random_state=0).fit_transform(emb)
    labels = [ds.labels[x][0] for x in X]
    uniq = sorted(set(labels))
    plt.figure(figsize=(7, 6))
    for c in uniq:
        idx = [i for i, lab in enumerate(labels) if lab == c]
        plt.scatter(pos[idx, 0], pos[idx, 1], s=6, label=c)
    if len(uniq) <= 20:
        plt.legend(markerscale=2, fontsize=7)
    plt.tight_layout()
    plt.savefig(path, dpi=150)
    plt.close()


def report(name, ds, results, t_train, args):
    if args.json:
        # one write a line: the ranks of a mesh share stdout, and an
        # unbuffered print writes the newline apart, so two lines could
        # interleave
        print(json.dumps({
            "model": name,
            "dataset": ds.name,
            "device": args.device,
            "train_s": round(t_train, 2),
            **{k: round(v, 4) for k, v in results.items()},
        }) + "\n", end="", flush=True)
    else:
        print(f"[{name}] {ds.name} on {args.device}: train {t_train:.1f}s  "
              + "  ".join(f"{k}={v:.4f}" for k, v in results.items()))


def run(name, dataset_default, build_and_train, parser=None, argv=None):
    """Generic example main: parse argv (default sys.argv) -> train ->
    evaluate -> report -> plot. `args.mesh` is the Mesh of --mesh (or
    None) when build_and_train runs. Returns (model, results, train
    seconds); the train time ends in a device synchronize."""
    import torch

    args = (parser or make_parser(name, dataset_default)).parse_args(argv)
    args.mesh = mesh_from_args(args)  # the Mesh, or None
    ds = load_dataset(args.dataset)
    t0 = time.perf_counter()
    model = build_and_train(ds, args)
    if torch.device(args.device).type == "cuda":
        torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    emb = model.get_embeddings()
    results = evaluate_embeddings(emb, ds, args.train_frac, args.seed)
    report(name, ds, results, t_train, args)
    if args.plot:
        plot_embeddings(emb, ds, args.plot)
    if args.mesh is not None:
        from graphembedding_tpu_torch.parallel.mesh import (
            destroy_distributed,
        )

        destroy_distributed()
    return model, results, t_train
