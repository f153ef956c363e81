"""The sparse cap of the port's hierarchical softmax against the JAX package.

- `hs_block_chunk(sparse_cap=True)` (`train/hsoftmax.py::
  sparse_capped_update`): four steps against the JAX chunk's from the same
  tables and the JAX draws, on two trees, with a cap that binds (1.0) and
  one that mostly does not (8.0), within rtol 1e-4, atol 1e-6 (the dense
  chunk's parity test holds 1e-5: the sparse form adds each row into the
  table in index order where JAX's scatter takes its own order); the
  port's sparse chunk against its dense chunk within the same.
- Pads are dropped (-1) by both scatters and counted into row 0's
  occupancy, as JAX counts them.
- `HSTrainer(cap_mode=)`: the JAX signature, and 'auto' against the JAX
  rule at 2^16 nodes; the sparse fit learns two cliques and resumes bit
  for bit; `train(hs=1, cap_mode=...)` is accepted and not passed on.
(`build_huffman`, bit-equal to the JAX function on tie-heavy inputs, is
held in tests/test_torch_hsoftmax.py.)
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu.train import hsoftmax as jhs
from graphembedding_tpu_torch import DeepWalk
from graphembedding_tpu_torch.data import datasets as tds
from graphembedding_tpu_torch.interop import hs_tables_from_jax
from graphembedding_tpu_torch.train import hsoftmax as ths
from graphembedding_tpu_torch.train import skipgram as tsg
from test_torch_checkpoint import Interrupt, StopAt
from test_torch_hsoftmax import _corpus

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's CPU training (several test
    processes run at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def tree_case(tree, seed=0):
    """(walks, counts): a corpus with pads and holes over V = 50 uniform
    ids ('uniform', depth 6-7), or over V = 120 zipf ids ('skewed', a deep
    and lopsided tree with hot rows near the root); row 0 a token beside
    pads in the first walks."""
    rng = np.random.default_rng(seed)
    if tree == "uniform":
        walks = _corpus(seed, V=50)
        V = 50
    else:
        V = 120
        walks = np.minimum(rng.zipf(1.5, (96, 8)) - 1, V - 1).astype(
            np.int32)
        walks[::5, 5:] = -1
        walks[3::7, 6] = -1
    walks[:4, 0] = 0
    walks[:4, 1:3] = -1
    counts = np.bincount(walks[walks >= 0], minlength=V).astype(np.float64)
    return walks, counts


def chunk_inputs(tree, seed=0):
    walks, counts = tree_case(tree, seed)
    V = counts.shape[0]
    points, codes, _ = jhs.build_huffman(counts)
    rng = np.random.default_rng(seed + 1)
    w_in = (rng.standard_normal((V, 16)) * 0.1).astype(np.float32)
    w_tree = (rng.standard_normal((V - 1, 16)) * 0.1).astype(np.float32)
    return walks, points, codes, w_in, w_tree


S, BW, W, T0 = 4, 32, 3, 5


def jax_chunk(walks, points, codes, w_in, w_tree, key, cap, sparse):
    out = jhs.hs_block_chunk(
        jnp.asarray(w_in), jnp.asarray(w_tree), jnp.asarray(walks),
        jnp.asarray(points), jnp.asarray(codes), key, jnp.float32(0.025),
        jnp.float32(1e-4), jnp.int32(T0), jnp.float32(40.0), chunk_steps=S,
        block_walks=BW, window=W, update_cap=cap, sparse_cap=sparse)
    return [np.asarray(x) for x in out]


def jax_draws(key, L):
    """The JAX chunk's window draws, by its own rule (`fold_in(key, t0)`)."""
    P = max(min(max(128 // L, 1), BW), 1)
    G, PL = BW // P, P * L
    return np.array(W - (jax.random.uniform(
        jax.random.fold_in(key, T0), (S, G, PL)) * W).astype(
            jnp.int32).clip(0, W - 1))


def port_chunk(walks, points, codes, w_in, w_tree, eff, cap, sparse,
               ops=ths.PLAIN):
    a, b = hs_tables_from_jax(w_in, w_tree)
    a, b, loss, pairs = ths.hs_block_chunk(
        a, b, torch.from_numpy(walks), torch.from_numpy(points),
        torch.from_numpy(codes), torch.from_numpy(eff), 0.025, 1e-4, T0,
        40.0, block_walks=BW, window=W, update_cap=cap, sparse_cap=sparse,
        ops=ops)
    return [x.numpy() for x in (a, b, loss, pairs)]


@pytest.mark.parametrize("cap", [8.0, 1.0])
@pytest.mark.parametrize("tree", ["uniform", "skewed"])
def test_sparse_chunk_matches_jax(tree, cap):
    """Four sparse-cap steps (V = 50 or 120, D = 16, L = 8, window 3, Bw =
    32) against JAX `hs_block_chunk(sparse_cap=True)`; at cap 1 every row
    touched more than once is capped."""
    walks, points, codes, w_in, w_tree = chunk_inputs(tree)
    key = jax.random.PRNGKey(3)
    want = jax_chunk(walks, points, codes, w_in, w_tree, key, cap, True)
    got = port_chunk(walks, points, codes, w_in, w_tree,
                     jax_draws(key, walks.shape[1]), cap, True,
                     ops=ths.KERNELS)
    for g, w in zip(got[:3], want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert np.abs(got[0][0] - w_in[0]).max() > 1e-4  # row 0 moved
    assert np.abs(got[1] - w_tree).max() > 1e-3
    assert (got[3] > 0).all()


@pytest.mark.parametrize("cap", [8.0, 1.0])
@pytest.mark.parametrize("tree", ["uniform", "skewed"])
def test_sparse_chunk_matches_dense(tree, cap):
    """The two forms compute the same update, in another order; the same
    losses and pair counts."""
    walks, points, codes, w_in, w_tree = chunk_inputs(tree, seed=4)
    eff = jax_draws(jax.random.PRNGKey(5), walks.shape[1])
    sparse = port_chunk(walks, points, codes, w_in, w_tree, eff, cap, True)
    dense = port_chunk(walks, points, codes, w_in, w_tree, eff, cap, False)
    for s, d in zip(sparse[:3], dense[:3]):
        np.testing.assert_allclose(s, d, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(sparse[3], dense[3])


def test_sparse_step_drops_pads_and_counts_them_into_row_zero():
    """One step of a block whose row-0 token sits beside pads: both
    scatters drop the pads (-1, zero rows), and row 0's token is scaled by
    cap / (1 + pads), as the JAX step counts the pads into row 0; the
    other tokens, seen once, by 1. The unscaled rows come from the dense
    form's scatter with no cap."""
    V, D = 10, 4
    points, codes, _ = ths.build_huffman(np.arange(1.0, V + 1))
    points, codes = torch.from_numpy(points), torch.from_numpy(codes)
    tok = torch.full((2, 16), -1, dtype=torch.int32)
    tok[0, :4] = torch.tensor([0, 3, 5, 7], dtype=torch.int32)
    ok, dm = tsg.window_geometry(8, 16, 3, "cpu")
    gen = torch.Generator().manual_seed(2)
    w_in = torch.randn((V, D), generator=gen)
    w_tree = torch.randn((V - 1, D), generator=gen)

    def calls(sparse, cap):
        seen = []

        def scatter(table, ids, grads):
            seen.append((ids.clone(), grads.clone()))
            return ths.PLAIN.scatter_add(table, ids, grads)

        ths.hs_step(w_in.clone(), w_tree.clone(), tok, torch.full(
            (2, 16), 3), points, codes, 0.5, window_ok=ok, dm=dm,
            update_cap=cap, sparse_cap=sparse,
            ops=ths.PLAIN._replace(scatter_add=scatter))
        return seen

    (raw_ids, raw_tok), (raw_tree_ids, raw_tree) = calls(False, 1e9)
    (ids, g_tok), (tree_ids, g_tree) = calls(True, 1.0)
    assert torch.equal(ids, tok.reshape(-1)) and torch.equal(ids, raw_ids)
    assert torch.equal(tree_ids, raw_tree_ids)
    assert (tree_ids.view(-1, points.shape[1])[ids < 0] == -1).all()
    pads = int((tok < 0).sum())
    assert not g_tok[ids < 0].any() and not g_tree[tree_ids < 0].any()
    assert torch.equal(g_tok[0], 0.5 * raw_tok[0] * (1.0 / (1 + pads)))
    assert torch.equal(g_tok[1:4], 0.5 * raw_tok[1:4])
    assert raw_tok[0].abs().max() > 0


class ChunkArgs(Exception):
    """Raised by a stand-in of the JAX chunk with its keyword arguments."""


@pytest.mark.parametrize("V", [(1 << 16) - 1, 1 << 16])
def test_auto_rule_matches_jax(V, monkeypatch):
    """The form `cap_mode='auto'` picks at V: the JAX HSTrainer's, read from
    the keyword its fit passes to its chunk, and the port's, read from the
    keyword its fit passes to its own."""

    def stop(*a, **kw):
        raise ChunkArgs(kw)

    walks = np.random.default_rng(0).integers(0, V, (64, 5)).astype(
        np.int32)
    monkeypatch.setattr(jhs, "hs_block_chunk", stop)
    monkeypatch.setattr(ths, "hs_block_chunk", stop)
    with pytest.raises(ChunkArgs) as want:
        jhs.HSTrainer(embed_size=2, epochs=1).fit(walks, V)
    with pytest.raises(ChunkArgs) as got:
        ths.HSTrainer(embed_size=2, epochs=1).fit(torch.from_numpy(walks), V)
    assert want.value.args[0]["sparse_cap"] == (V >= 1 << 16)
    assert got.value.args[0]["sparse_cap"] == want.value.args[0][
        "sparse_cap"]


def test_fit_takes_the_form_of_its_cap_mode(monkeypatch):
    """HSTrainer.fit passes `sparse_cap_for(cap_mode, V)` to every chunk:
    'auto' takes the sparse form from SPARSE_CAP_MIN_NODES (here 30) on,
    the dense form below; an unknown cap_mode raises."""
    seen = []
    chunk = ths.hs_block_chunk

    def spy(*a, **kw):
        seen.append(kw["sparse_cap"])
        return chunk(*a, **kw)

    monkeypatch.setattr(ths, "hs_block_chunk", spy)
    monkeypatch.setattr(tsg, "SPARSE_CAP_MIN_NODES", 30)
    walks = torch.from_numpy(_corpus(3, V=29, NW=40))
    for mode, V, want in (("auto", 30, True), ("auto", 29, False),
                          ("sparse", 29, True), ("dense", 30, False)):
        seen.clear()
        w_in, w_tree, losses = ths.HSTrainer(
            embed_size=8, epochs=1, chunk_steps=2, cap_mode=mode).fit(
                walks, V, seed=1)
        assert seen and set(seen) == {want}, (mode, V)
        assert torch.isfinite(w_in).all() and torch.isfinite(losses).all()
    with pytest.raises(ValueError):
        ths.HSTrainer(cap_mode="Sparse").fit(walks, 29)


def test_hs_trainer_signature_equals_jax():
    def params(cls):
        return [(n, p.kind, p.default) for n, p in
                inspect.signature(cls.__init__).parameters.items()]

    assert params(ths.HSTrainer) == params(jhs.HSTrainer)
    assert ths.HSTrainer().cap_mode == jhs.HSTrainer().cap_mode == "auto"


def test_train_hs_accepts_cap_mode_and_ignores_it():
    """As in the JAX package: `train(hs=1, cap_mode=...)` builds HSTrainer
    without it, so the fit takes 'auto' (the dense form at this V) and the
    tables are those of `train(hs=1)` bit for bit."""
    ds = tds.synthetic_wiki(num_nodes=40, num_classes=2, seed=3)
    m = DeepWalk(ds.graph, walk_length=6, num_walks=4, device="cpu")
    tables = []
    for kw in ({}, {"cap_mode": "sparse"}, {"cap_mode": "dense"}):
        m.train(embed_size=8, window_size=2, iter=1, hs=1, **kw)
        tables.append((m.w_in.clone(), m.w_out.clone(), m.losses.clone()))
    for other in tables[1:]:
        assert all(torch.equal(a, b) for a, b in zip(tables[0], other))


def test_sparse_hs_trainer_two_cliques():
    """tests/test_hsoftmax.py::test_hs_trainer_big_corpus_switch_trains:
    cap_mode='sparse' end to end still learns two cliques."""
    rng = np.random.default_rng(7)
    V = 20
    walks = np.asarray([rng.integers(s * 10, s * 10 + 10, size=8)
                        for s in rng.integers(0, 2, 300)], dtype=np.int32)
    tr = ths.HSTrainer(embed_size=16, window=2, epochs=3, block_walks=64,
                       cap_mode="sparse")
    w_in, w_tree, losses = tr.fit(torch.from_numpy(walks), V)
    assert torch.isfinite(losses).all()
    emb = w_in.numpy()
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    sims = emb @ emb.T
    same = ((sims[:10, :10].sum() - 10) / 90
            + (sims[10:, 10:].sum() - 10) / 90)
    assert same / 2 > sims[:10, 10:].mean() * 2 + 0.1


def test_sparse_fit_resumes_bit_identical(tmp_path):
    """A sparse-cap fit cut after chunk 5 of 9 (3 an epoch, a checkpoint
    every 2) and run again from its checkpoint inside epoch 1: the tables
    of an uninterrupted fit, bit for bit, and the losses of the chunks
    after the checkpoint."""
    walks = torch.from_numpy(_corpus(1, V=30, NW=192))
    kw = dict(embed_size=8, window=2, epochs=3, block_walks=32,
              chunk_steps=2, cap_mode="sparse")
    want_in, want_tree, want_losses = ths.HSTrainer(**kw).fit(walks, 30)
    d = str(tmp_path)
    with pytest.raises(Interrupt):
        ths.HSTrainer(**kw).fit(walks, 30, checkpoint_dir=d,
                                checkpoint_every=2, metrics=StopAt(5))
    w_in, w_tree, losses = ths.HSTrainer(**kw).fit(
        walks, 30, checkpoint_dir=d, checkpoint_every=2)
    assert torch.equal(w_in, want_in) and torch.equal(w_tree, want_tree)
    assert torch.equal(losses, want_losses[8:])
