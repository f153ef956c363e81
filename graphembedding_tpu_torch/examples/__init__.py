"""The example entry points, one module each:

    python -m graphembedding_tpu_torch.examples.deepwalk_wiki [--json]
    python -m graphembedding_tpu_torch.examples.node2vec_wiki
    python -m graphembedding_tpu_torch.examples.line_wiki
    python -m graphembedding_tpu_torch.examples.line_blogcatalog
    python -m graphembedding_tpu_torch.examples.sdne_wiki
    python -m graphembedding_tpu_torch.examples.struc2vec_flight
    python -m graphembedding_tpu_torch.examples.deepwalk_multihost \
        --coordinator HOST:PORT --num-processes N --process-id I

Counterparts of the JAX package's `examples/*.py`, with their arguments and
defaults plus `--device` (the card by default; `--device cpu` runs on the
CPU). Each trains, then prints micro- and macro-F1 of a logistic
regression on a split of the labels. Under `torchrun`, `--mesh DATA[xMODEL]`
trains over a mesh of its ranks (`common.mesh_from_args`).
"""
