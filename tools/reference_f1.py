"""The JAX package's micro-F1 by seed, on the CPU.

The reference figures behind the quality gates of `chip_smoke.py`'s SDNE,
dense-trainer and BlogCatalog LINE phases: each configuration is trained
by `graphembedding_tpu` with the model seed given, on the Wiki-scale graph
(`line_blogcatalog`: the BlogCatalog-scale one, as
`examples/line_blogcatalog.py` trains it), then scored by its Classifier
on the 0.8 split with split seed 0, as `chip_smoke.py` scores the port.
Prints one JSON line a (configuration, seed).

    JAX_PLATFORMS=cpu python tools/reference_f1.py [--seeds 0 1 2]
        [--configs sdne_full sdne_minibatch sdne_sparse deepwalk_dense
                   line_dense line_blogcatalog]

The default is every configuration but `line_blogcatalog` (one to a few
minutes a seed on a CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CONFIGS = {
    "sdne_full": "SDNE([256, 128]).train(batch_size=3000, epochs=40)",
    "sdne_minibatch": "SDNE([256, 128]).train(batch_size=1024, epochs=40)",
    "sdne_sparse": "SDNE([256, 128]).train_sparse(epochs=40)",
    "deepwalk_dense": "DeepWalk(10, 80).train(embed_size=128, "
                      "window_size=5, trainer='dense')",
    "line_dense": "LINE(128, 'second').train(trainer='dense')",
    "line_blogcatalog": "LINE(128, 'all').train(batch_size=1024, "
                        "epochs=50) on blogcatalog",
}
DATASET = {"line_blogcatalog": "blogcatalog"}


def train(name, graph, seed):
    from graphembedding_tpu.models import LINE, SDNE, DeepWalk

    if name.startswith("sdne"):
        m = SDNE(graph, hidden_size=[256, 128], seed=seed)
        if name == "sdne_full":
            return m.train(batch_size=3000, epochs=40)
        if name == "sdne_minibatch":
            return m.train(batch_size=1024, epochs=40)
        return m.train_sparse(epochs=40)
    if name == "deepwalk_dense":
        m = DeepWalk(graph, walk_length=10, num_walks=80, seed=seed)
        return m.train(embed_size=128, window_size=5, trainer="dense")
    if name == "line_blogcatalog":
        m = LINE(graph, embedding_size=128, order="all", seed=seed)
        return m.train(batch_size=1024, epochs=50)
    m = LINE(graph, embedding_size=128, order="second", seed=seed)
    return m.train(trainer="dense")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--configs", nargs="+",
                   default=[c for c in CONFIGS if c not in DATASET],
                   choices=list(CONFIGS))
    args = p.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    from graphembedding_tpu.data import load_dataset
    from graphembedding_tpu.eval.classify import Classifier

    for name in args.configs:
        ds = load_dataset(DATASET.get(name, "wiki"))
        for seed in args.seeds:
            model = train(name, ds.graph, seed)
            res = Classifier(model.get_embeddings()).split_train_evaluate(
                ds.X, ds.Y, 0.8, seed=0)
            print(json.dumps({"config": name, "call": CONFIGS[name],
                              "seed": seed, "micro": res["micro"],
                              "macro": res["macro"],
                              "platform": jax.devices()[0].platform}),
                  flush=True)


if __name__ == "__main__":
    main()
