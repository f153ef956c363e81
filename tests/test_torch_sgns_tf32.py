"""Why K1 takes each product three times in TF32.

The CUDA kernel (graphembedding_tpu_torch/csrc/sgns.cu) runs all six
products on the tensor cores in TF32: each operand is split x = hi + lo,
hi rounded to TF32 (10 mantissa bits, to nearest, ties away from zero)
and lo, the remainder, cut to TF32 toward zero; a product is lo.hi +
hi.lo + hi.hi with f32 sums. This emulates that
arithmetic in numpy (TF32 x TF32 products are exact in f32; the sums are
f32) at the DeepWalk step's per-group shapes (PL = 120, D = 128, K = 64)
and holds it to K1's tolerance, rtol=2e-4 / atol=1e-5, against the plain
version and the JAX oracle. One TF32 pass (hi.hi) misses that tolerance,
which is why the kernel pays for three.
"""

import numpy as np
import pytest
import torch

from graphembedding_tpu.ops.pallas_sgns import sgns_block_grads_xla
from graphembedding_tpu_torch.ops.sgns import sgns_block_grads_plain

RTOL, ATOL = 2e-4, 1e-5
PL, D, K = 120, 128, 64


def tf32(x):
    """Round float32 to TF32: 10 mantissa bits, nearest, ties away from
    zero (cvt.rna.tf32.f32); the low 13 bits come back zero."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def tf32_rz(x):
    """Cut float32 to TF32 toward zero: the low 13 bits cleared."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split3(a, b):
    """a @ b as the kernel takes it: lo.hi + hi.lo + hi.hi."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32_rz(a - ah), tf32_rz(b - bh)
    return (al @ bh + ah @ bl) + ah @ bh


def single(a, b):
    """a @ b in one TF32 pass."""
    return tf32(a) @ tf32(b)


def block_grads(yin, yout, vn, mask, neg_ok, neg_w, mm):
    """(d_yin, d_yout, d_vn, loss) of sgns_block_grads_plain with each of
    the six products taken by mm; everything else in f32."""
    G = yin.shape[0]
    G2 = vn.shape[0]
    r = G // G2
    sigmoid = lambda x: np.float32(1) / (np.float32(1) + np.exp(-x))  # noqa
    log_sigmoid = lambda x: -np.logaddexp(np.float32(0), -x)  # noqa
    t = lambda a: a.transpose(0, 2, 1)  # noqa: E731
    logits = mm(yin, t(yout))
    g_pos = (sigmoid(logits) - 1) * mask
    yin_n = yin.reshape(G2, r * PL, D)
    nlog = mm(yin_n, t(vn))
    np_w = (mask.sum(2).reshape(G2, r * PL) * np.float32(neg_w))[:, :, None]
    g_neg = sigmoid(nlog) * np_w * neg_ok
    d_yin = mm(g_pos, yout) + mm(g_neg, vn).reshape(G, PL, D)
    d_yout = mm(t(g_pos), yin)
    d_vn = mm(t(g_neg), yin_n)
    pos = np.where(mask > 0, log_sigmoid(logits), 0) * mask
    neg = (log_sigmoid(-nlog) * np_w * neg_ok).reshape(G, PL * K)
    loss = -(pos.sum((1, 2)) + neg.sum(1))
    return d_yin, d_yout, d_vn, loss.astype(np.float32)


def inputs(G, G2, seed):
    """The card test's inputs: rows of std 0.3, mask density 0.2."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (
        (rng.standard_normal((G, PL, D)) * 0.3).astype(f32),
        (rng.standard_normal((G, PL, D)) * 0.3).astype(f32),
        (rng.standard_normal((G2, K, D)) * 0.3).astype(f32),
        (rng.random((G, PL, PL)) < 0.2).astype(f32),
        (rng.random((G2, G // G2 * PL, K)) < 0.9).astype(f32),
    )


def outside(got, want):
    """Elements of got outside rtol / atol of want."""
    return int((np.abs(got - want) > ATOL + RTOL * np.abs(want)).sum())


# r = 4 (the step's negative sharing) and r = 1, a few groups each
@pytest.mark.parametrize("G,G2", [(8, 2), (3, 3)])
def test_split_tf32_holds_k1_tolerance(G, G2):
    ins = inputs(G, G2, seed=G * 10 + G2)
    neg_w = 5.0 / K
    r = G // G2
    got = block_grads(*ins, neg_w, split3)
    plain = [t.numpy() for t in sgns_block_grads_plain(
        *map(torch.from_numpy, ins), neg_w)]
    oracle = [np.asarray(t) for t in sgns_block_grads_xla(*ins, neg_w)]
    names = ("d_yin", "d_yout", "d_vn")
    for g, p, o, name in zip(got[:3], plain[:3], oracle[:3], names):
        np.testing.assert_allclose(g, p, rtol=RTOL, atol=ATOL, err_msg=name)
        np.testing.assert_allclose(g, o, rtol=RTOL, atol=ATOL, err_msg=name)
    # the loss as the kernel splits it (each group its own negative share)
    # and, summed over each sharing group, as the oracle splits it
    np.testing.assert_allclose(got[3], plain[3], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[3].reshape(G2, r).sum(1),
                               oracle[3].reshape(G2, r).sum(1), rtol=RTOL,
                               atol=ATOL)

    # one pass keeps about three digits: thousands of gradient elements
    # fall outside the same tolerance
    one = block_grads(*ins, neg_w, single)
    missed = sum(outside(g, p) for g, p in zip(one[:3], plain[:3]))
    assert missed > 1000, missed
