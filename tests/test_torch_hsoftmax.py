"""The port's hierarchical-softmax trainer against the JAX package's.

`build_huffman` must give the JAX package's arrays bit for bit. Four HS
steps from the same tables (`interop.hs_tables_from_jax`) and the same
window draws (made by the JAX rule, `fold_in(key, t0)`) hold rtol 1e-5,
atol 1e-6 against JAX `hs_block_chunk` on w_in, w_tree and the losses: the
products and sums run in another order, in float32 on both sides. The
trainer tests are ports of `tests/test_hsoftmax.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu.train import hsoftmax as jhs
from graphembedding_tpu_torch import DeepWalk, Node2Vec
from graphembedding_tpu_torch.data import datasets as tds
from graphembedding_tpu_torch.eval.classify import Classifier
from graphembedding_tpu_torch.interop import hs_tables_from_jax
from graphembedding_tpu_torch.train import hsoftmax as ths
from graphembedding_tpu_torch.train.skipgram import (
    block_geometry,
    fit_block_walks,
    window_geometry,
)
from test_torch_card import riding_hs_step


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Two torch threads for this file's CPU training (several test
    processes run at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _counts(case):
    rng = np.random.default_rng(4)
    return {
        "one": np.array([7.0]),
        "two": np.array([3.0, 3.0]),
        "ties": np.array([5.0, 1.0, 1.0, 1.0, 1.0, 5.0, 2.0, 2.0, 0.0, 0.0]),
        "all_equal": np.full(17, 4.0),
        "zeros": np.zeros(6),
        "random": rng.integers(0, 50, 300).astype(np.float64),
        "skewed": np.floor(1e4 / np.arange(1, 2406)),
    }[case]


@pytest.mark.parametrize("case", ["one", "two", "ties", "all_equal",
                                  "zeros", "random", "skewed"])
def test_build_huffman_equals_jax(case):
    counts = _counts(case)
    P, C, depth = ths.build_huffman(counts)
    Pj, Cj, depth_j = jhs.build_huffman(counts)
    assert depth == depth_j
    assert P.dtype == Pj.dtype and C.dtype == Cj.dtype
    np.testing.assert_array_equal(P, Pj)
    np.testing.assert_array_equal(C, Cj)


def _corpus(seed, V=50, NW=96, L=8):
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, V, (NW, L)).astype(np.int32)
    walks[::5, 5:] = -1  # walks that stop early
    walks[3::7, 6] = -1  # holes a subsampled corpus leaves
    return walks


@pytest.mark.parametrize("update_cap,tree", [(2.0, "random"),
                                             (8.0, "zeros")])
def test_four_hs_steps_match_jax(update_cap, tree):
    """Four steps (V = 50, D = 16, L = 8, window 3, Bw = 32: G = 2 groups of
    PL = 128) with -1 pads; update_cap 2 makes the cap bind on hot rows."""
    V, D, W, S, Bw, t0 = 50, 16, 3, 4, 32, 5
    walks = _corpus(0, V=V)
    NW, L = walks.shape
    counts = np.bincount(walks[walks >= 0], minlength=V).astype(np.float64)
    points, codes, _ = jhs.build_huffman(counts)
    rng = np.random.default_rng(1)
    w_in0 = (rng.standard_normal((V, D)) * 0.1).astype(np.float32)
    w_tree0 = (np.zeros((V - 1, D)) if tree == "zeros"
               else rng.standard_normal((V - 1, D)) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jw_in, jw_tree, jloss = jhs.hs_block_chunk(
        jnp.asarray(w_in0), jnp.asarray(w_tree0), jnp.asarray(walks),
        jnp.asarray(points), jnp.asarray(codes), key, jnp.float32(0.025),
        jnp.float32(1e-4), jnp.int32(t0), jnp.float32(40.0), chunk_steps=S,
        block_walks=Bw, window=W, update_cap=update_cap)
    # the JAX chunk's window draws, by its own rule
    P = max(min(max(128 // L, 1), Bw), 1)
    G, PL = Bw // P, P * L
    eff = W - (jax.random.uniform(jax.random.fold_in(key, t0), (S, G, PL))
               * W).astype(jnp.int32).clip(0, W - 1)

    w_in, w_tree = hs_tables_from_jax(w_in0, w_tree0)
    w_in, w_tree, loss, pairs = ths.hs_block_chunk(
        w_in, w_tree, torch.from_numpy(walks), torch.from_numpy(points),
        torch.from_numpy(codes), torch.from_numpy(np.array(eff)), 0.025,
        1e-4, t0, 40.0, block_walks=Bw, window=W, update_cap=update_cap)
    for got, want in ((w_in, jw_in), (w_tree, jw_tree), (loss, jloss)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    assert (w_in.numpy() - w_in0).std() > 1e-4  # it moved
    assert pairs.shape == (S,) and (pairs > 0).all()


def test_hs_step_drops_pads_as_jax_counts_them():
    """A block of one token and pads: no pairs and no update; the pads go
    to both scatters as -1 (dropped) with zero gradient rows. (The
    occupancy, a 1-D sum apart in which the pads count at row 0 as in the
    JAX step, is held against JAX by the four-step test.)"""
    V, D = 10, 4
    w_in = torch.randn((V, D))
    w_tree = torch.randn((V - 1, D))
    before = (w_in.clone(), w_tree.clone())
    points, codes, _ = ths.build_huffman(np.arange(1.0, V + 1))
    tok = torch.full((2, 16), -1, dtype=torch.int32)
    tok[0, 0] = 3
    ok, dm = window_geometry(8, 16, 3, "cpu")
    calls = []

    def scatter(table, ids, grads):
        calls.append((ids.clone(), grads.clone()))
        return ths.PLAIN.scatter_add(table, ids, grads)

    loss, pairs = ths.hs_step(
        w_in, w_tree, tok, torch.full((2, 16), 3), torch.from_numpy(points),
        torch.from_numpy(codes), 0.1, window_ok=ok, dm=dm, update_cap=8.0,
        ops=ths.PLAIN._replace(scatter_add=scatter))
    assert float(pairs) == 0 and float(loss) == 0
    assert torch.equal(w_in, before[0]) and torch.equal(w_tree, before[1])
    (tok_ids, tok_g), (tree_ids, tree_g) = calls
    assert (tok_ids == tok.reshape(-1)).all()
    assert tuple(tok_g.shape) == (32, D) and not tok_g.any()
    assert (tree_ids[tok.reshape(-1).repeat_interleave(
        points.shape[1]) < 0] == -1).all()
    assert not tree_g.any()



def _steps(step, w_in, w_tree, walks, points, codes, eff, ops, update_cap):
    """Each block of walks through `step` in turn; (w_in, w_tree, losses,
    pairs)."""
    NW, L = walks.shape
    geo = block_geometry(NW, L, 32, 1)
    ok, dm = window_geometry(L, geo.PL, 3, "cpu")
    out = []
    for s in range(eff.shape[0]):
        off = s % geo.n_blocks * geo.Bw
        tok = walks[off: off + geo.Bw].reshape(geo.G, geo.PL)
        out.append(step(w_in, w_tree, tok, eff[s], points, codes,
                        0.025 * (1 - s / 10), window_ok=ok, dm=dm,
                        update_cap=update_cap, ops=ops))
    return (w_in, w_tree, torch.stack([o[0] for o in out]),
            torch.stack([o[1] for o in out]))


@pytest.mark.parametrize("update_cap,seed", [(1.0, 0), (2.0, 1), (8.0, 2),
                                             (1e9, 3)])
def test_hs_step_equals_riding_column_form(update_cap, seed):
    """Six steps with the occupancy apart (1-D sums) equal six steps of
    the form in which it rode as a last gradient column, bit for bit: w_in,
    w_tree, the losses and the pair counts (the walks hold pads and holes;
    update_cap 1 and 2 bind on hot rows, 1e9 never)."""
    V, D, S = 50, 16, 6
    walks = torch.from_numpy(_corpus(seed, V=V))
    NW, L = walks.shape
    counts = np.bincount(walks[walks >= 0].numpy(), minlength=V)
    points, codes, _ = ths.build_huffman(counts.astype(np.float64))
    points, codes = torch.from_numpy(points), torch.from_numpy(codes)
    geo = block_geometry(NW, L, 32, 1)
    rng = np.random.default_rng(seed)
    eff = torch.from_numpy(rng.integers(1, 4, (S, geo.G, geo.PL))
                           .astype(np.int32))
    w_in = torch.from_numpy((rng.standard_normal((V, D)) * 0.1)
                            .astype(np.float32))
    w_tree = torch.from_numpy((rng.standard_normal((V - 1, D)) * 0.1)
                              .astype(np.float32))
    got = _steps(ths.hs_step, w_in.clone(), w_tree.clone(), walks, points,
                 codes, eff, ths.PLAIN, update_cap)
    want = _steps(riding_hs_step, w_in.clone(), w_tree.clone(), walks,
                  points, codes, eff, ths.PLAIN, update_cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got[0], w_in)  # it moved


def test_hs_step_scatters_contiguous_rows():
    """Both scatters of a step take contiguous float32 [N, D] gradients
    (16-byte rows where D % 4 == 0): the tokens' [G * PL, D] and the
    tree's [G * PL * T, D]."""
    V, D = 50, 16
    walks = torch.from_numpy(_corpus(4, V=V))
    NW, L = walks.shape
    counts = np.bincount(walks[walks >= 0].numpy(), minlength=V)
    points, codes, T = ths.build_huffman(counts.astype(np.float64))
    geo = block_geometry(NW, L, 32, 1)
    seen = []

    def scatter(table, ids, grads):
        seen.append((tuple(table.shape), ids.shape, grads))
        return ths.PLAIN.scatter_add(table, ids, grads)

    _steps(ths.hs_step, torch.randn((V, D)), torch.randn((V - 1, D)),
           walks, torch.from_numpy(points), torch.from_numpy(codes),
           torch.full((1, geo.G, geo.PL), 3, dtype=torch.int32),
           ths.PLAIN._replace(scatter_add=scatter), 8.0)
    (tok_t, tok_n, tok_g), (tree_t, tree_n, tree_g) = seen
    assert tok_t == (V, D) and tree_t == (V - 1, D)
    assert tuple(tok_g.shape) == (geo.G * geo.PL, D) == (tok_n[0], D)
    assert tuple(tree_g.shape) == (geo.G * geo.PL * T, D) == (tree_n[0], D)
    for g in (tok_g, tree_g):
        assert g.dtype == torch.float32 and g.is_contiguous()

def test_hs_block_geometry_follows_jax():
    """Block and step counts of the JAX HSTrainer (no block upscaling): the
    same number of losses from one fit."""
    walks = _corpus(2, V=30, NW=200, L=10)
    for kw in (dict(block_walks=504, chunk_steps=8),
               dict(block_walks=36, chunk_steps=4)):
        ours = ths.HSTrainer(embed_size=4, window=2, epochs=2, **kw).fit(
            torch.from_numpy(walks), 30)[2]
        ref = jhs.HSTrainer(embed_size=4, window=2, epochs=2, **kw).fit(
            walks, 30)[2]
        assert ours.shape[0] == np.asarray(ref).shape[0]
    assert fit_block_walks(192400, 10, 504) == 504
    assert fit_block_walks(10480, 10, 504) == 504
    assert fit_block_walks(100, 10, 504) == 24


def test_hs_trainer_two_cliques():
    rng = np.random.default_rng(2)
    V = 20
    walks = np.asarray([rng.integers(s * 10, s * 10 + 10, size=8)
                        for s in rng.integers(0, 2, 400)], dtype=np.int32)
    tr = ths.HSTrainer(embed_size=16, window=3, epochs=4, block_walks=64,
                       alpha=0.05, chunk_steps=8)
    w_in, w_tree, losses = tr.fit(torch.from_numpy(walks), V)
    assert torch.isfinite(losses).all()
    assert tuple(w_tree.shape) == (V - 1, 16)
    emb = w_in.numpy() / np.linalg.norm(w_in.numpy(), axis=1, keepdims=True)
    sims = emb @ emb.T
    within = ((sims[:10, :10].sum() - 10) / 90
              + (sims[10:, 10:].sum() - 10) / 90) / 2
    assert within > sims[:10, 10:].mean() + 0.2


def test_hs_loss_decreases():
    """tests/test_hsoftmax.py's loss test on walks around a ring of 30
    nodes: its corpus of uniform ids holds nothing to learn (the JAX loss
    moves 3.416 -> 3.401 there, within its step-to-step noise)."""
    rng = np.random.default_rng(3)
    walks = torch.from_numpy(((rng.integers(0, 30, (256, 1))
                               + np.arange(8)) % 30).astype(np.int32))
    tr = ths.HSTrainer(embed_size=8, window=2, epochs=6, block_walks=32,
                       alpha=0.1, chunk_steps=8)
    _, _, losses = tr.fit(walks, 30)
    assert torch.isfinite(losses).all()
    assert losses[-8:].mean() < losses[:8].mean()
    assert tr.trained_pairs_ > 0


def test_hs_trainer_options(tmp_path):
    # mesh= is ported (tests/test_torch_parallel*.py) and takes a
    # parallel.mesh.Mesh only
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        ths.HSTrainer(mesh=object())
    walks = torch.zeros((8, 4), dtype=torch.int32)
    # checkpoints and metrics are ported (tests/test_torch_checkpoint.py)
    logged = []

    class Lines:
        def log(self, **fields):
            logged.append(fields)

    _, _, losses = ths.HSTrainer(embed_size=4, epochs=1).fit(
        walks, 3, checkpoint_dir=str(tmp_path), checkpoint_every=1,
        metrics=Lines())
    assert [f["kind"] for f in logged] == ["hs_chunk"]
    assert logged[0]["step"] == losses.shape[0] == 64
    assert ths.HSTrainer(embed_size=4, epochs=1).fit(
        walks, 3, checkpoint_dir=str(tmp_path))[2].shape == (0,)
    # a one-node corpus: a tree of one padded row, and one tree row
    w_in, w_tree, _ = ths.HSTrainer(embed_size=4, epochs=1).fit(walks, 1)
    assert tuple(w_in.shape) == (1, 4) and tuple(w_tree.shape) == (1, 4)
    assert not w_tree.any()


def test_hs_matmuls_in_full_f32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with ths.f32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)


def test_deepwalk_hs_model_path():
    """DeepWalk(...).train(hs=1), the reference's Word2Vec(hs=1) objective,
    through the model API, with the JAX test's graph and bound."""
    ds = tds.synthetic_wiki(num_nodes=120, num_classes=3, avg_degree=8,
                            p_in=0.85, seed=3)
    m = DeepWalk(ds.graph, walk_length=10, num_walks=20, seed=0,
                 device="cpu")
    m.train(embed_size=32, window_size=5, iter=3, hs=1)
    assert tuple(m.w_out.shape) == (119, 32)  # the tree table
    emb = m.get_embeddings()
    assert np.isfinite(next(iter(emb.values()))).all()
    res = Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8)
    assert res["micro"] > 0.6, res["micro"]


def test_hs_kwargs_win_over_arguments():
    """As in the JAX package: window, epochs and seed kwargs override the
    explicit arguments, and seed + 1 seeds the fit."""
    ds = tds.synthetic_wiki(num_nodes=40, num_classes=2, seed=3)
    m = Node2Vec(ds.graph, walk_length=6, num_walks=4, device="cpu")
    m.train(embed_size=8, window_size=5, iter=5, hs=1, window=2, epochs=1,
            seed=7)
    a = m.w_in.clone()
    tr = ths.HSTrainer(embed_size=8, window=2, epochs=1, seed=7)
    w_in, _, losses = tr.fit(m.walks, 40, seed=8)
    assert torch.equal(a, w_in) and m.losses.shape == losses.shape
