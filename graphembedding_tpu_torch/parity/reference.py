"""Pure-numpy reference forwards for per-layer allclose parity tests.

The port's copy of `graphembedding_tpu/parity/reference.py`, carried as
is (numpy only, so the port never imports the JAX package). BASELINE.json
requires "match the reference implementation's per-layer activations
(allclose)". The original reference is Keras/TF1 (`ge/models/line.py`,
`ge/models/sdne.py [U]`); these are direct numpy transcriptions of its
forward semantics (SURVEY.md §4.3/§4.4), used by the port's tests to pin
its models:

- LINE: first-order logit = <emb_i, emb_j>; second-order logit =
  <emb_i, ctx_j>; loss = -mean(log sigmoid(sign * logit)).
- SDNE: relu Dense encoder stack -> Y; relu Dense decoder -> A_hat;
  l_2nd = mean_b sum((A - A_hat) * b)^2 with b = beta where A != 0;
  l_1st = alpha * 2 * tr(Y^T L Y) / batch; plus L1+L2 weight reg.
"""

from __future__ import annotations

import numpy as np


def sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def line_forward(emb, ctx, h, t, order):
    """Logits for edge batch (h, t). order: 'first' | 'second'."""
    emb = np.asarray(emb)
    if order == "first":
        return np.sum(emb[h] * emb[t], axis=-1)
    return np.sum(emb[h] * np.asarray(ctx)[t], axis=-1)


def line_loss(logits, sign):
    return float(-np.mean(np.log(sigmoid(sign * logits) + 1e-12)))


def relu(x):
    return np.maximum(x, 0.0)


def mlp_forward(params, x):
    """Per-layer activations of a relu Dense stack.

    params: list of {"w": [in, out], "b": [out]} (numpy).
    Returns list of activations AFTER each layer (excluding input).
    """
    acts = []
    for layer in params:
        x = relu(x @ np.asarray(layer["w"]) + np.asarray(layer["b"]))
        acts.append(x)
    return acts


def sdne_forward(enc_params, dec_params, a_rows):
    """(encoder activations, decoder activations); y = enc_acts[-1]."""
    enc_acts = mlp_forward(enc_params, np.asarray(a_rows))
    dec_acts = mlp_forward(dec_params, enc_acts[-1])
    return enc_acts, dec_acts


def sdne_losses(a_rows, a_hat, y, l_block, alpha, beta):
    b_ = np.where(np.asarray(a_rows) != 0, beta, 1.0)
    l2nd = float(np.mean(np.sum(np.square((a_rows - a_hat) * b_), axis=-1)))
    l1st = float(
        alpha * 2.0 * np.trace(y.T @ np.asarray(l_block) @ y)
        / a_rows.shape[0]
    )
    return l2nd, l1st


def sdne_reg(enc_params, dec_params, nu1, nu2):
    reg = 0.0
    for stack in (enc_params, dec_params):
        for layer in stack:
            w = np.asarray(layer["w"])
            reg += nu1 * np.abs(w).sum() + nu2 * np.square(w).sum()
    return float(reg)


def sgns_pair_grads(w_in, w_out, center, context, negs):
    """Single-pair SGNS gradients (gensim semantics, one update)."""
    w_in = np.asarray(w_in)
    w_out = np.asarray(w_out)
    u = w_in[center]
    v = w_out[context]
    g_pos = sigmoid(u @ v) - 1.0
    d_u = g_pos * v
    d_v = g_pos * u
    d_negs = []
    for n in negs:
        if n == context:
            d_negs.append(np.zeros_like(u))
            continue
        vn = w_out[n]
        g = sigmoid(u @ vn)
        d_u = d_u + g * vn
        d_negs.append(g * u)
    return d_u, d_v, d_negs
