"""Node2Vec (Grover and Leskovec, KDD 2016): (p,q) walks, then skip-gram
(`walk_skipgram`)."""

from gebench.models.walk_skipgram import (  # noqa: F401
    CHECKS, controls, judge, model_flops, nominal_pairs, outputs,
    run_constants, train, train_bytes, walk_args, walk_bytes)


def build(graph, cfg, seed, device):
    """The model; its constructor walks the corpus."""
    from graphembedding_tpu_torch import Node2Vec

    return Node2Vec(graph, p=cfg["p"], q=cfg["q"],
                    **walk_args(cfg, seed, device))
