"""Port's SGNS trainer against graphembedding_tpu/train/skipgram.py.

Fixed by their inputs, so compared exactly or allclose: the negative
table, keep-probabilities, the per-epoch compaction, the block plan, and
four steps of `sgns_block_chunk_cat` fed the JAX package's own draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu.train import skipgram as jsg
from graphembedding_tpu_torch.interop import tables_from_jax, tables_to_numpy
from graphembedding_tpu_torch.train import skipgram as tsg


def make_corpus(V=120, NW=200, L=10, seed=0):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, V, (NW, L)).astype(np.int32)
    # dead-ended walks: -1 tails on a fifth of the rows
    cut = rng.integers(2, L, NW)
    tails = (np.arange(L)[None, :] >= cut[:, None]) & (
        rng.random(NW) < 0.2)[:, None]
    walks[tails] = -1
    return walks


def test_counts_negative_table_and_keep_probs():
    walks = make_corpus()
    counts = tsg.corpus_counts(torch.from_numpy(walks), 130)
    np.testing.assert_array_equal(counts, jsg.corpus_counts(walks, 130))
    for size in (1 << 10, 1 << 16):
        np.testing.assert_array_equal(
            tsg.negative_table(counts, 0.75, size),
            jsg.negative_table(counts, 0.75, size))
    np.testing.assert_array_equal(tsg.subsample_keep_probs(counts, 1e-3),
                                  jsg.subsample_keep_probs(counts, 1e-3))
    assert tsg.subsample_keep_probs(counts, 0) is None
    # the JAX trainer's on-device f32 prep agrees to f32 rounding
    _, _, keep = jsg._device_prep(jnp.asarray(walks), num_nodes=130,
                                  size=1 << 10, exponent=0.75, sample=1e-3)
    np.testing.assert_allclose(tsg.subsample_keep_probs(counts, 1e-3),
                               np.asarray(keep), rtol=1e-5)


def test_subsample_compact_bit_equal():
    walks = make_corpus(seed=1)
    rng = np.random.default_rng(2)
    kprob = rng.random(walks.shape).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jsg._subsample_compact(jnp.asarray(walks), jnp.asarray(kprob), key)
    u = np.array(jax.random.uniform(key, walks.shape))
    got = tsg._subsample_compact(torch.from_numpy(walks),
                                 torch.from_numpy(kprob),
                                 torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prepare_epoch_bit_equal_given_permutation():
    walks = make_corpus(seed=4)
    keep_tok = np.random.default_rng(5).random(walks.shape).astype(
        np.float32)
    key = jax.random.PRNGKey(6)
    want = jsg._prepare_epoch(jnp.asarray(walks), jnp.asarray(keep_tok), key)
    kp, ks = jax.random.split(key)
    perm = torch.from_numpy(
        np.array(jax.random.permutation(kp, walks.shape[0])))
    u = torch.from_numpy(np.array(jax.random.uniform(ks, walks.shape)))
    got = tsg._subsample_compact(torch.from_numpy(walks)[perm],
                                 torch.from_numpy(keep_tok)[perm], u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("NW,L,V", [(192400, 10, 2405), (12000, 10, 600),
                                    (200, 10, 120), (40, 7, 30)])
def test_block_plan_matches(NW, L, V):
    cfg = jsg.SkipGramConfig()
    bw = jsg.plan_block_walks(NW, L, V, cfg)
    assert tsg.plan_block_walks(NW, L, V, tsg.SkipGramConfig()) == bw
    geo = tsg.block_geometry(NW, L, bw, cfg.neg_share_packs)
    assert geo.Bw == bw and geo.G * geo.P == bw and geo.G % geo.nsp == 0


def jax_draws(key, t0, S, G, PL, G2, K, W, neg_table):
    """The draws of skipgram.py:396-405, recomputed outside the jit."""
    k1, k2 = jax.random.split(jax.random.fold_in(key, t0))
    eff = W - (jax.random.uniform(k1, (S, G, PL)) * W).astype(
        jnp.int32).clip(0, W - 1)
    neg_idx = jax.random.randint(k2, (S, G2, K), 0, neg_table.shape[0],
                                 dtype=jnp.int32)
    return np.array(eff), np.array(neg_table[neg_idx])


def test_four_steps_match_jax_chunk():
    """The slice's step parity: four steps of JAX sgns_block_chunk_cat
    (dense cap) against the port's chunk on the same table and draws."""
    V, D, L, NW, Bw, K, W, S, t0 = 120, 16, 10, 200, 48, 8, 5, 4, 5
    walks = make_corpus(V, NW, L, seed=7)
    rng = np.random.default_rng(8)
    w_in = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    w_out = (rng.standard_normal((V, D)) * 0.3).astype(np.float32)
    neg_table = jnp.asarray(jsg.negative_table(
        jsg.corpus_counts(walks, V), 0.75, 1 << 12))
    key = jax.random.PRNGKey(9)
    kw = dict(block_walks=Bw, window=W, negative=5, neg_share_packs=2)
    want, want_loss, want_pairs = jsg.sgns_block_chunk_cat(
        jnp.concatenate([w_in, w_out], 1), jnp.asarray(walks), neg_table,
        key, jnp.float32(0.025), jnp.float32(1e-4), jnp.int32(t0),
        jnp.float32(20.0), chunk_steps=S, k_shared=K, neg_share_walks=8,
        sparse_cap=False, **kw)

    geo = tsg.block_geometry(NW, L, Bw, 2)
    assert (geo.G, geo.PL, geo.G2, geo.n_blocks) == (4, 120, 2, 4)
    eff, negs = jax_draws(key, t0, S, geo.G, geo.PL, geo.G2, K, W,
                          neg_table)
    w_cat = tables_from_jax(w_in, w_out)
    got, loss, pairs = tsg.sgns_block_chunk_cat(
        w_cat, torch.from_numpy(walks), torch.from_numpy(eff),
        torch.from_numpy(negs), 0.025, 1e-4, t0, 20.0, **kw)
    assert got is w_cat  # updated in place
    got_in, got_out = tables_to_numpy(got)
    want = np.asarray(want)
    np.testing.assert_allclose(got_in, want[:, :D], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got_out, want[:, D:], rtol=1e-4, atol=1e-6)
    assert np.abs(got_out - w_out).max() > 1e-3  # the steps moved it
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(want_pairs))
    np.testing.assert_allclose(loss.numpy(), np.asarray(want_loss),
                               rtol=1e-4)


def test_chunk_rejects_mismatched_draws():
    walks = torch.from_numpy(make_corpus())
    w_cat = torch.zeros((120, 32))
    with pytest.raises(ValueError):
        tsg.sgns_block_chunk_cat(
            w_cat, walks, torch.ones((2, 3, 120), dtype=torch.int32),
            torch.zeros((2, 2, 8), dtype=torch.int32), 0.025, 1e-4, 0, 10.0,
            block_walks=48, window=5, negative=5, neg_share_packs=2)


def test_fit_trains_on_cpu():
    walks = torch.from_numpy(make_corpus(seed=10))
    tr = tsg.SkipGramTrainer(embed_size=16, epochs=2, chunk_steps=4,
                             block_walks=48)
    w_cat, losses = tr.fit(walks, 120, seed=1)
    assert w_cat.shape == (120, 32) and losses.shape == (8,)
    assert torch.isfinite(w_cat).all() and torch.isfinite(losses).all()
    assert tr.trained_pairs_ > 0
    assert w_cat[:, 16:].abs().max() > 0  # w_out starts at zero
