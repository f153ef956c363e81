"""Dense expected-SGNS trainer: full-batch Adam on the closed-form
objective, for small graphs.

Counterpart of `graphembedding_tpu/train/dense.py`. In place of streaming
(center, context, negatives) samples, it trains the EXPECTED
skip-gram-negative-sampling objective

    L(U, W) = - sum_{c,x} C[c,x] * log sigma(u_c . w_x)
              - sum_{c,x} negative * occ[c] * q[x] * log sigma(-u_c . w_x)

where C is the expected window-pair count matrix of the walk corpus (the
dynamic window enters as its expectation P(eff >= d) = (W-d+1)/W),
occ[c] = sum_x C[c,x], and q the unigram^0.75 negative distribution.
Frequent-node subsampling is not folded into C, as in the JAX package.
Each step is three [V, V] x [V, D] products (cuBLAS on the card), all in
full float32 (matmul precision "highest"); TF32 would change the results.
A fit's steps run as one CUDA graph on the card (`dense_fit`).

The co-occurrence counts each distance's pairs as integers and sums
w_d * N_d in a fixed order of d, so C is the same from run to run on the
card (a float scatter-add with atomics would not be). The initial table
U0 is an input of `dense_fit`; `initial_table` draws it from a
`torch.Generator(seed)` on the CPU, so it does not depend on the device.
The walk models and LINE run it through `trainer='dense'`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from graphembedding_tpu_torch.train.adam import (
    AdamConfig,
    adam_update,
    bias_corrections,
)
from graphembedding_tpu_torch.train.chunk_graph import run_chunk
from graphembedding_tpu_torch.utils.precision import f32_matmul

# the co-occurrence's flat index a * V + b overflows int32 in the JAX
# package above floor(sqrt(2^31)) nodes; both packages refuse such a V
MAX_FLAT_NODES = 46340


def cooccurrence(walks, num_nodes, window):
    """Expected window-pair count matrix C [V, V] (f32) of walks [NW, L].

    Ordered pairs at distance d in the same walk weigh (W-d+1)/W each way;
    pad tokens (-1) count for nothing.
    """
    V, W = num_nodes, window
    L = walks.shape[1]
    walks = walks.long()
    C = torch.zeros(V * V, device=walks.device)
    for d in range(1, min(W, L - 1) + 1):
        a, b = walks[:, :L - d].reshape(-1), walks[:, d:].reshape(-1)
        ok = (a >= 0) & (b >= 0)
        # pairs with a pad land in the extra slot V * V, which is dropped
        flat = torch.cat([torch.where(ok, a * V + b, V * V),
                          torch.where(ok, b * V + a, V * V)])
        n_d = torch.bincount(flat, minlength=V * V + 1)[:V * V]
        C += n_d.float() * float(np.float32((W - d + 1) / W))
    return C.view(V, V)


def initial_table(num_nodes, embed_size, seed, device):
    """U0 [V, D] = (U[0, 1) - 0.5) / D from a CPU `torch.Generator(seed)`,
    moved to `device`."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.rand((num_nodes, embed_size), generator=gen)
    return ((u - 0.5) / embed_size).to(device)


@dataclass
class DenseSGNSConfig:
    embed_size: int = 128
    window: int = 5
    negative: int = 5
    ns_exponent: float = 0.75
    steps: int = 300
    lr: float = 0.1  # Adam on a noise-free full-batch gradient
    b1: float = 0.9
    b2: float = 0.99
    eps: float = 1e-8
    seed: int = 0
    max_nodes: int = 1 << 15  # [V,V] buffers bound the method


class DenseSGNSTrainer:
    """Full-batch expected-SGNS via Adam on the closed-form gradient."""

    def __init__(self, config: DenseSGNSConfig | None = None, **kw):
        self.config = config or DenseSGNSConfig(**kw)

    def fit(self, walks, num_nodes, seed=None):
        """walks [NW, L] int (-1 pads) on the device to train on; U0 from
        `seed` (the config's seed when None). Returns (w_in [V, D], w_out
        [V, D], losses [1])."""
        cfg = self.config
        if num_nodes > cfg.max_nodes:
            raise ValueError(
                f"dense trainer is for V <= {cfg.max_nodes} (got "
                f"{num_nodes}); use the walk-block trainer at scale")
        if num_nodes > MAX_FLAT_NODES:
            raise ValueError(
                "dense trainer's flat co-occurrence index overflows int32 "
                f"above V={MAX_FLAT_NODES} (got {num_nodes})")
        walks = torch.as_tensor(walks)
        C = cooccurrence(walks, num_nodes, cfg.window)
        U0 = initial_table(num_nodes, cfg.embed_size,
                           cfg.seed if seed is None else seed, walks.device)
        return dense_fit(C, U0, cfg.negative, cfg.ns_exponent, cfg.lr,
                         cfg.b1, cfg.b2, cfg.eps, steps=cfg.steps)


def dense_step(b, s, ops, *, tied, adam):
    """Step s of a dense fit on its buffers (`chunk_graph.run_chunk`): the
    closed-form gradient of the normalized expected-SGNS loss, then Adam
    on U (and W) in place."""
    del ops  # no kernel of the port
    U, W = b["U"], b["W"]
    logits = U @ (U.T if tied else W.T)
    S = torch.sigmoid(logits)
    G = (b["C"] * (S - 1.0) + b["occ_n"] * b["q_row"] * S) * b["scale"]
    if tied:
        tables, grads = "U", [(G + G.T) @ U]
    else:
        tables, grads = "UW", [G @ W, G.T @ U]
    adam_update([b[t] for t in tables], grads,
                [b[f"m{t}"] for t in tables], [b[f"v{t}"] for t in tables],
                b["bc1"][s], b["bc2"][s], adam)
    return ()


def dense_fit(C, U0, negative, ns_exponent, lr, b1, b2, eps, *, steps,
              q=None, tied=False):
    """Adam on the closed-form expected-SGNS gradient, from U0 and W0 = 0.

    C [V, V]: expected positive-pair weights (co-occurrence counts for walk
    corpora; the weighted adjacency for LINE's edge sampling). q (optional
    [V]): the negative distribution; defaults to the corpus
    unigram^ns_exponent. `tied=True` trains one shared table (LINE
    first-order's symmetric dot): the gradient becomes (G + G^T) @ U and W
    stays 0. Adam is `train/adam.py`'s, in optax's order of operations.
    The steps run as the JAX package's one scan: on a card one CUDA graph
    (`chunk_graph.run_chunk`) whose inputs are C, the rank-1 factors of
    the negative term, the normalization and the bias corrections; on the
    CPU the loop. Returns (U, W, loss [1]), the loss evaluated once, after
    the last step.
    """
    f32 = np.float32
    adam = AdamConfig(*(float(f32(x)) for x in (lr, b1, b2, eps)))
    with f32_matmul():
        occ = C.sum(1)  # expected pair count per center
        if q is None:
            counts = C.sum(1) + C.sum(0)
            q = counts.clamp(min=0.0).pow(float(ns_exponent))
        q = q / q.sum().clamp(min=1e-12)
        # the rank-1 factors of the negative term, never a [V, V] matrix
        # held across the steps
        occ_n = (float(f32(negative)) * occ)[:, None]
        q_row = q[None, :]
        scale = 1.0 / C.sum().clamp(min=1.0)  # per-pair normalization

        U = U0.clone()
        W = torch.zeros_like(U0)
        tables = {"U": U, "mU": torch.zeros_like(U0),
                  "vU": torch.zeros_like(U0)}
        if not tied:
            tables.update(W=W, mW=torch.zeros_like(U0),
                          vW=torch.zeros_like(U0))
        bc1, bc2 = bias_corrections(adam.b1, adam.b2, 0, steps, U0.device)
        inputs = {"C": C, "occ_n": occ_n, "q_row": q_row, "scale": scale,
                  "bc1": bc1, "bc2": bc2, **({"W": W} if tied else {})}
        run_chunk(dense_step, steps, tables, inputs,
                  consts=dict(tied=tied, adam=adam))
        # the loss as one final evaluation, not one a step
        logits = U @ (U.T if tied else W.T)
        loss = -((C * F.logsigmoid(logits)).sum()
                 + (occ_n * q_row * F.logsigmoid(-logits)).sum()) * scale
    return U, W, loss[None]
