"""DeepWalk (Perozzi et al., KDD 2014): uniform walks, then skip-gram
(`walk_skipgram`)."""

from gebench.models.walk_skipgram import (  # noqa: F401
    CHECKS, controls, judge, model_flops, nominal_pairs, outputs,
    run_constants, train, train_bytes, walk_args, walk_bytes)


def build(graph, cfg, seed, device):
    """The model; its constructor walks the corpus."""
    from graphembedding_tpu_torch import DeepWalk

    return DeepWalk(graph, **walk_args(cfg, seed, device))
