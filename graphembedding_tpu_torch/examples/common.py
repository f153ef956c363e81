"""Shared example plumbing: the command line, evaluation and the t-SNE plot.

Counterpart of the JAX package's `examples/common.py`, with `--device` in
place of `--mesh` (the examples train on one device; `train(mesh=)` is
driven from code, see `graphembedding_tpu_torch.parallel`).
"""

from __future__ import annotations

import argparse
import json
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
    return p


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
        print(json.dumps({
            "model": name,
            "dataset": ds.name,
            "device": args.device,
            "train_s": round(t_train, 2),
            **{k: round(v, 4) for k, v in results.items()},
        }))
    else:
        print(f"[{name}] {ds.name} on {args.device}: train {t_train:.1f}s  "
              + "  ".join(f"{k}={v:.4f}" for k, v in results.items()))


def run(name, dataset_default, build_and_train, parser=None, argv=None):
    """Generic example main: parse argv (default sys.argv) -> train ->
    evaluate -> report -> plot. Returns (model, results, train seconds);
    the train time ends in a device synchronize."""
    import torch

    args = (parser or make_parser(name, dataset_default)).parse_args(argv)
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
    return model, results, t_train
