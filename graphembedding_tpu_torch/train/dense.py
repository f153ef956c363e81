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


def dense_fit(C, U0, negative, ns_exponent, lr, b1, b2, eps, *, steps,
              q=None, tied=False):
    """Adam on the closed-form expected-SGNS gradient, from U0 and W0 = 0.

    C [V, V]: expected positive-pair weights (co-occurrence counts for walk
    corpora; the weighted adjacency for LINE's edge sampling). q (optional
    [V]): the negative distribution; defaults to the corpus
    unigram^ns_exponent. `tied=True` trains one shared table (LINE
    first-order's symmetric dot): the gradient becomes (G + G^T) @ U and W
    stays 0. Adam is written out with the JAX package's float32 constants.
    Returns (U, W, loss [1]), the loss evaluated once, after the last step.
    """
    f32 = np.float32
    negative, lr, b1, b2, eps = (f32(x) for x in (negative, lr, b1, b2, eps))
    with f32_matmul():
        occ = C.sum(1)  # expected pair count per center
        if q is None:
            counts = C.sum(1) + C.sum(0)
            q = counts.clamp(min=0.0).pow(float(ns_exponent))
        q = q / q.sum().clamp(min=1e-12)
        # the rank-1 factors of the negative term, never a [V, V] matrix
        # held across the steps
        occ_n = (float(negative) * occ)[:, None]
        q_row = q[None, :]
        scale = 1.0 / C.sum().clamp(min=1.0)  # per-pair normalization

        U = U0.clone()
        W = torch.zeros_like(U0)
        state = [torch.zeros_like(U0) for _ in range(4)]  # mU, vU, mW, vW

        def adam(p, g, m, v, t):
            m = float(b1) * m + float(f32(1) - b1) * g
            v = float(b2) * v + float(f32(1) - b2) * g * g
            mhat = m / float(f32(1) - b1 ** f32(t))
            vhat = v / float(f32(1) - b2 ** f32(t))
            return p - float(lr) * mhat / (vhat.sqrt() + float(eps)), m, v

        for t in range(1, steps + 1):
            logits = U @ (U.T if tied else W.T)
            S = torch.sigmoid(logits)
            G = (C * (S - 1.0) + occ_n * q_row * S) * scale
            if tied:
                U, state[0], state[1] = adam(U, (G + G.T) @ U, state[0],
                                             state[1], t)
            else:
                dU, dW = G @ W, G.T @ U
                U, state[0], state[1] = adam(U, dU, state[0], state[1], t)
                W, state[2], state[3] = adam(W, dW, state[2], state[3], t)
        # the loss as one final evaluation, not one a step
        logits = U @ (U.T if tied else W.T)
        loss = -((C * F.logsigmoid(logits)).sum()
                 + (occ_n * q_row * F.logsigmoid(-logits)).sum()) * scale
    return U, W, loss[None]
