"""SDNE at a size the CPU runs: the tests' model module, not one of the
benchmark's. Self-contained, so that its text is a model module as it
stands: a test writes it into a copy of the tree under
`gebench/models/`, or re-exports it from a module written there."""

import torch

CHECKS = ("embed_gap",)


def build(graph, cfg, seed, device):
    from graphembedding_tpu_torch import SDNE

    return SDNE(graph, hidden_size=cfg["hidden_size"], seed=seed,
                device=device)


def train(fit, cfg):
    fit.train_sparse(epochs=cfg["epochs"])


def run_constants(cfg, row_ptr, col):
    return {}


def nominal_pairs(cfg, V, E):
    return V * V * cfg["epochs"]


def model_flops(cfg, V, E, constants):
    return None


def walk_bytes(cfg, V, E):
    return None


def train_bytes(cfg, V, E):
    return None


def outputs(fit):
    return ({k: v.detach().clone() for k, v in
             fit.net.state_dict().items()}, fit.embedding_table)


def judge(outputs, fit_seed, cfg, csr, law_seed):
    """The largest gap of the trained embeddings from the encoder
    recomputed in plain torch on the dense adjacency (a repeated edge
    counted each time), relative to the largest embedding."""
    params, table = outputs
    x = torch.zeros(csr.V, csr.V)
    x.index_put_((torch.repeat_interleave(torch.arange(csr.V), csr.deg),
                  csr.col), torch.ones(csr.col.shape), accumulate=True)
    for i in range(len(cfg["hidden_size"])):
        x = torch.relu(x @ params[f"enc.{i}.w"] + params[f"enc.{i}.b"])
    return {"embed_gap": float((table - x).abs().max() / x.abs().max())}
