"""The JAX package's micro-F1 by seed, on the CPU.

The reference figures behind the quality gates of `chip_smoke.py`'s SDNE,
dense-trainer, BlogCatalog LINE and mesh phases: each configuration is trained
by `graphembedding_tpu` with the model seed given, on the Wiki-scale graph
(`line_blogcatalog`: the BlogCatalog-scale one, as
`examples/line_blogcatalog.py` trains it), then scored by its Classifier
on the 0.8 split with split seed 0, as `chip_smoke.py` scores the port.
The `mesh_*` configurations train with mesh= over a (2, 1) mesh of two
virtual CPU devices (the tool asks XLA for them); the `mesh_walks_*` ones
also walk over it (the model built with mesh=; Struc2Vec on flight-brazil).
Prints one JSON line a (configuration, seed).

    JAX_PLATFORMS=cpu python tools/reference_f1.py [--seeds 0 1 2]
        [--configs sdne_full sdne_minibatch sdne_sparse deepwalk_dense
                   line_dense line_blogcatalog mesh_deepwalk_rowshard
                   mesh_deepwalk_rowshard_prefetch mesh_deepwalk_dp mesh_deepwalk_hs mesh_line mesh_sdne
                   mesh_walks_deepwalk_rowshard mesh_walks_deepwalk_dp
                   mesh_walks_deepwalk_a2a mesh_walks_node2vec
                   mesh_walks_struc2vec]

The default is every configuration but `line_blogcatalog` and the mesh ones
(one to a few minutes a seed on a CPU; the mesh ones take longer).
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
    "mesh_deepwalk_rowshard": "DeepWalk(10, 80).train(embed_size=128, "
                              "window_size=5, iter=3, mesh=(2, 1))",
    "mesh_deepwalk_rowshard_prefetch": "DeepWalk(10, 80).train("
                                       "embed_size=128, window_size=5, "
                                       "iter=3, mesh=(2, 1), "
                                       "rowshard_prefetch=True)",
    "mesh_deepwalk_dp": "DeepWalk(10, 80).train(embed_size=128, "
                        "window_size=5, iter=3, mesh=(2, 1), "
                        "parallel_mode='dp')",
    "mesh_deepwalk_hs": "DeepWalk(10, 80).train(embed_size=128, "
                        "window_size=5, iter=3, hs=1, mesh=(2, 1))",
    "mesh_line": "LINE(128, 'second').train(batch_size=1024, epochs=50, "
                 "mesh=(2, 1))",
    "mesh_sdne": "SDNE([256, 128]).train(batch_size=3000, epochs=40, "
                 "mesh=(2, 1))",
    "mesh_walks_deepwalk_rowshard": "DeepWalk(10, 80, mesh=(2, 1)).train("
                                    "embed_size=128, window_size=5, iter=3)",
    "mesh_walks_deepwalk_dp": "DeepWalk(10, 80, mesh=(2, 1)).train("
                              "embed_size=128, window_size=5, iter=3, "
                              "parallel_mode='dp')",
    "mesh_walks_deepwalk_a2a": "DeepWalk(10, 80, mesh=(2, 1), "
                               "walk_exchange='a2a').train(embed_size=128, "
                               "window_size=5, iter=3, parallel_mode='dp')",
    "mesh_walks_node2vec": "Node2Vec(10, 80, p=0.25, q=4, mesh=(2, 1))."
                           "train(embed_size=128, window_size=5, iter=3, "
                           "parallel_mode='dp')",
    "mesh_walks_struc2vec": "Struc2Vec(10, 80, workers=4, mesh=(2, 1))."
                            "train(embed_size=128, window_size=5, iter=5) "
                            "on flight-brazil",
}
DATASET = {"line_blogcatalog": "blogcatalog",
           "mesh_walks_struc2vec": "flight-brazil"}
DEFAULT = [c for c in CONFIGS if c not in DATASET
           and not c.startswith("mesh_")]


def mesh_of_two():
    import jax

    from graphembedding_tpu.parallel.mesh import make_mesh

    return make_mesh((2, 1), devices=jax.devices()[:2])


def train(name, graph, seed):
    from graphembedding_tpu.models import (
        LINE,
        SDNE,
        DeepWalk,
        Node2Vec,
        Struc2Vec,
    )

    if name.startswith("mesh_walks_"):
        mesh = mesh_of_two()
        dp = {} if name.endswith("rowshard") else {"parallel_mode": "dp"}
        if name == "mesh_walks_struc2vec":
            import tempfile

            with tempfile.TemporaryDirectory() as tmp:
                m = Struc2Vec(graph, walk_length=10, num_walks=80,
                              workers=4, seed=seed, mesh=mesh,
                              temp_path=tmp + "/")
            return m.train(embed_size=128, window_size=5, iter=5)
        if name == "mesh_walks_node2vec":
            m = Node2Vec(graph, walk_length=10, num_walks=80, p=0.25, q=4.0,
                         seed=seed, mesh=mesh)
        else:
            m = DeepWalk(graph, walk_length=10, num_walks=80, seed=seed,
                         mesh=mesh, walk_exchange=(
                             "a2a" if name.endswith("a2a") else None))
        return m.train(embed_size=128, window_size=5, iter=3, **dp)
    if name.startswith("mesh_deepwalk"):
        m = DeepWalk(graph, walk_length=10, num_walks=80, seed=seed)
        kw = {"mesh_deepwalk_dp": dict(parallel_mode="dp"),
              "mesh_deepwalk_hs": dict(hs=1),
              "mesh_deepwalk_rowshard_prefetch": dict(
                  rowshard_prefetch=True)}.get(name, {})
        return m.train(embed_size=128, window_size=5, iter=3,
                       mesh=mesh_of_two(), **kw)
    if name == "mesh_line":
        m = LINE(graph, embedding_size=128, order="second", seed=seed)
        return m.train(batch_size=1024, epochs=50, mesh=mesh_of_two())
    if name == "mesh_sdne":
        m = SDNE(graph, hidden_size=[256, 128], seed=seed)
        return m.train(batch_size=3000, epochs=40, mesh=mesh_of_two())
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
    p.add_argument("--configs", nargs="+", default=DEFAULT,
                   choices=list(CONFIGS))
    args = p.parse_args(argv)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=2").strip()
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
