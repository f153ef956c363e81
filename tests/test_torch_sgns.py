"""Port's SGNS block gradients (K1) against the JAX package's.

The plain version (what the wrapper runs for CPU tensors) is held against
`sgns_block_grads_xla` and `sgns_block_grads_pallas(interpret=True)` on
the same numpy inputs; tests/test_torch_card.py holds the CUDA kernel
against the plain version. Tolerance rtol=2e-4, atol=1e-5: f32 sums in
another order, as in tests/test_pallas_sgns.py.
"""

import numpy as np
import pytest
import torch

from graphembedding_tpu.ops.pallas_sgns import (
    sgns_block_grads_pallas,
    sgns_block_grads_xla,
)
from graphembedding_tpu_torch.ops.sgns import sgns_block_grads

RTOL, ATOL = 2e-4, 1e-5


def make_inputs(G, PL, D, K, G2, seed):
    rng = np.random.default_rng(seed)
    r = G // G2
    f32 = np.float32
    return (
        (rng.standard_normal((G, PL, D)) * 0.3).astype(f32),
        (rng.standard_normal((G, PL, D)) * 0.3).astype(f32),
        (rng.standard_normal((G2, K, D)) * 0.3).astype(f32),
        (rng.random((G, PL, PL)) < 0.2).astype(f32),
        (rng.random((G2, r * PL, K)) < 0.9).astype(f32),
    )


# the shapes of tests/test_pallas_sgns.py: r = 1 and r = 3, and r = 2
CASES = [(3, 24, 16, 8, 3), (6, 24, 16, 8, 2), (4, 24, 16, 8, 2)]


@pytest.mark.parametrize("oracle", ["xla", "pallas"])
@pytest.mark.parametrize("G,PL,D,K,G2", CASES)
def test_plain_matches_jax(oracle, G, PL, D, K, G2):
    inputs = make_inputs(G, PL, D, K, G2, seed=G * 10 + G2)
    neg_w = 5.0 / K
    if oracle == "xla":
        want = sgns_block_grads_xla(*inputs, neg_w)
    else:
        want = sgns_block_grads_pallas(*inputs, neg_w, interpret=True)
    got = sgns_block_grads(*map(torch.from_numpy, inputs), neg_w)
    for g, w, name in zip(got[:3], want[:3], ["d_yin", "d_yout", "d_vn"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    # per-group loss split differs from the XLA oracle when r > 1; the
    # sums over each sharing group agree
    r = G // G2
    np.testing.assert_allclose(
        got[3].numpy().reshape(G2, r).sum(1),
        np.asarray(want[3]).reshape(G2, r).sum(1), rtol=RTOL, atol=1e-4)
    if oracle == "pallas":
        np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                                   rtol=RTOL, atol=1e-4)


def test_zero_mask_zero_pos_grads():
    yin, yout, vn, mask, neg_ok = map(
        torch.from_numpy, make_inputs(3, 24, 16, 8, 3, seed=1))
    d_yin, d_yout, d_vn, loss = sgns_block_grads(
        yin, yout, vn, torch.zeros_like(mask), neg_ok, 1.0)
    # no pairs: n_pairs = 0 also zeroes every negative weight
    for t in (d_yin, d_yout, d_vn, loss):
        np.testing.assert_allclose(t.numpy(), 0, atol=1e-6)


def test_wrapper_checks_shapes():
    yin, yout, vn, mask, neg_ok = map(
        torch.from_numpy, make_inputs(4, 24, 16, 8, 2, seed=2))
    with pytest.raises(ValueError):
        sgns_block_grads(yin, yout, vn, mask, neg_ok[:, :24], 1.0)
    with pytest.raises(ValueError):
        sgns_block_grads(yin, yout, vn, mask.double(), neg_ok, 1.0)
