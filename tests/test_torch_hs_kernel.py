"""The hs=1 step's scoring (K10, `ops/hs.py`) on the CPU.

K10 itself runs only on a card (tests/test_torch_card.py holds it against
its plain version there). Here: the plain version is the step's dense
products as `train.hsoftmax.hs_step` computed them inline before K10, bit
for bit, and through `hs_block_chunk` it matches the JAX package's HS
chunk; `hs_step` scores through `ops.block_grads` (K10 under KERNELS)
only where no `reduce` is given, and keeps the dense products under
`reduce` and under PLAIN; `train.hs_kernel_steps` counts a chunk's steps
only on the kernel's route; K10's decomposition (walks found from dm, a
context's centers in tiles, zero rows where no pair reaches), written out
in float64, gives the plain version's function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from graphembedding_tpu.train import hsoftmax as jhs
from graphembedding_tpu_torch.interop import hs_tables_from_jax
from graphembedding_tpu_torch.ops import hs as ohs
from graphembedding_tpu_torch.train import hsoftmax as ths
from graphembedding_tpu_torch.train import skipgram as sg
from graphembedding_tpu_torch.utils.profiling import record


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def step_inputs(seed, V=60, D=16, L=8, Bw=32, W=3, dtype=torch.float32):
    """One block of a random corpus with dead-ended walks and holes, its
    Huffman paths, window draws and tables."""
    rng = np.random.default_rng(seed)
    walks = rng.integers(0, V, (Bw, L)).astype(np.int32)
    walks[::5, 5:] = -1
    walks[3::7, L // 2] = -1
    counts = np.bincount(walks[walks >= 0], minlength=V).astype(np.float64)
    points, codes, _ = ths.build_huffman(counts)
    geo = sg.block_geometry(Bw, L, Bw, 1)
    tok = torch.from_numpy(walks[:geo.Bw]).reshape(geo.G, geo.PL)
    gen = torch.Generator().manual_seed(seed)
    eff = sg.window_draws(gen, (geo.G, geo.PL), W)
    w_in = torch.from_numpy(rng.standard_normal((V, D)) * 0.3).to(dtype)
    w_tree = torch.from_numpy(rng.standard_normal((V - 1, D)) * 0.3).to(dtype)
    ok, dm = sg.window_geometry(L, geo.PL, W, "cpu")
    return (w_in, w_tree, tok, eff, torch.from_numpy(points),
            torch.from_numpy(codes).to(dtype), ok, dm)


def inline_products(w_in, w_tree, tok, eff_b, points, codes, window_ok, dm):
    """The products `hs_step` computed inline before K10, as it wrote
    them: (d_yin, d_tree, loss sum)."""
    G, PL = tok.shape
    D = w_in.shape[1]
    T = points.shape[1]
    N = PL * T
    tok_ok = tok >= 0
    tok_safe = torch.where(tok_ok, tok, 0)
    yin = w_in.index_select(0, tok_safe.reshape(-1).long()).view(G, PL, D)
    pts = points[tok_safe]
    label = 1.0 - codes[tok_safe]
    pts_ok = (pts >= 0) & tok_ok[:, :, None]
    pts_safe = torch.where(pts_ok, pts, 0)
    ptv = w_tree.index_select(0, pts_safe.reshape(-1).long()).view(G, N, D)
    mask = (window_ok[None] & (dm[None] <= eff_b[:, :, None])
            & tok_ok[:, :, None] & tok_ok[:, None, :]).to(torch.float32)
    logits = torch.bmm(yin, ptv.transpose(1, 2))
    gate_n = (mask[:, :, :, None] * pts_ok[:, None, :, :]).reshape(G, PL, N)
    gmat = (label.reshape(G, 1, N) - torch.sigmoid(logits)) * gate_n
    d_yin = torch.bmm(gmat, ptv)
    d_tree = torch.bmm(gmat.transpose(1, 2), yin)
    sgn = 2.0 * label.reshape(G, 1, N) - 1.0
    ll = F.logsigmoid(sgn * logits)
    return d_yin.reshape(-1, D), d_tree.reshape(-1, D), -(ll * gate_n).sum()


@pytest.mark.parametrize("seed,L,W", [(0, 8, 3), (1, 10, 5), (2, 5, 7)])
def test_plain_equals_the_inline_products(seed, L, W):
    """The plain version, and the wrapper on CPU tensors, give the step's
    former inline products bit for bit."""
    inputs = step_inputs(seed, L=L, W=W)
    want = inline_products(*inputs)
    for fn in (ohs.hs_block_grads_plain, ohs.hs_block_grads):
        for got, w in zip(fn(*inputs), want):
            assert torch.equal(got, w)


@pytest.mark.parametrize("ops", ["KERNELS", "PLAIN"])
def test_four_hs_steps_match_jax_by_route(ops):
    """Four HS steps through each route (the wrapper, which takes the
    plain version on the CPU, or PLAIN) against JAX `hs_block_chunk`:
    rtol 1e-5, atol 1e-6, as tests/test_torch_hsoftmax.py holds them."""
    V, D, W, S, Bw, t0 = 50, 16, 3, 4, 32, 2
    rng = np.random.default_rng(5)
    walks = rng.integers(0, V, (96, 8)).astype(np.int32)
    walks[::5, 5:] = -1
    counts = np.bincount(walks[walks >= 0], minlength=V).astype(np.float64)
    points, codes, _ = jhs.build_huffman(counts)
    w_in0 = (rng.standard_normal((V, D)) * 0.1).astype(np.float32)
    w_tree0 = (rng.standard_normal((V - 1, D)) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jw_in, jw_tree, jloss = jhs.hs_block_chunk(
        jnp.asarray(w_in0), jnp.asarray(w_tree0), jnp.asarray(walks),
        jnp.asarray(points), jnp.asarray(codes), key, jnp.float32(0.025),
        jnp.float32(1e-4), jnp.int32(t0), jnp.float32(40.0), chunk_steps=S,
        block_walks=Bw, window=W, update_cap=8.0)
    G, PL = Bw // 16, 128
    eff = W - (jax.random.uniform(jax.random.fold_in(key, t0), (S, G, PL))
               * W).astype(jnp.int32).clip(0, W - 1)
    w_in, w_tree = hs_tables_from_jax(w_in0, w_tree0)
    w_in, w_tree, loss, _ = ths.hs_block_chunk(
        w_in, w_tree, torch.from_numpy(walks), torch.from_numpy(points),
        torch.from_numpy(codes), torch.from_numpy(np.array(eff)), 0.025,
        1e-4, t0, 40.0, block_walks=Bw, window=W, ops=getattr(ths, ops))
    for got, want in ((w_in, jw_in), (w_tree, jw_tree), (loss, jloss)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("route", ["kernels", "reduce", "plain"])
def test_hs_step_routes_the_scoring(route):
    """Under KERNELS with no `reduce` the step scores through
    `ops.block_grads` (K10's wrapper); with a `reduce`, or under PLAIN,
    through the dense products, `reduce` applied to the logits. Every
    route updates the tables to the same bits here (the wrapper takes the
    plain version on the CPU; the reduce is the identity)."""
    inputs = step_inputs(3)
    w_in, w_tree, tok, eff, points, codes, ok, dm = inputs
    calls = {"block_grads": 0, "reduce": 0}

    def block_grads(*a):
        calls["block_grads"] += 1
        return ohs.hs_block_grads(*a)

    def reduce(x):
        calls["reduce"] += 1
        return x

    ops = {"kernels": ths.KERNELS._replace(block_grads=block_grads),
           "reduce": ths.KERNELS._replace(block_grads=block_grads),
           "plain": ths.PLAIN}[route]
    got = [w_in.clone(), w_tree.clone()]
    ths.hs_step(*got, tok, eff, points, codes, 0.025, window_ok=ok, dm=dm,
                update_cap=8.0, ops=ops,
                reduce=reduce if route == "reduce" else None)
    want = [w_in.clone(), w_tree.clone()]
    ths.hs_step(*want, tok, eff, points, codes, 0.025, window_ok=ok, dm=dm,
                update_cap=8.0, ops=ths.PLAIN)
    assert calls == {"kernels": {"block_grads": 1, "reduce": 0},
                     "reduce": {"block_grads": 0, "reduce": 1},
                     "plain": {"block_grads": 0, "reduce": 0}}[route]
    assert ths.PLAIN.block_grads is ohs.hs_block_grads_plain
    assert ths.KERNELS.block_grads is ohs.hs_block_grads
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("ops", ["KERNELS", "PLAIN"])
def test_hs_kernel_steps_counts_the_kernel_route(ops):
    """`train.hs_kernel_steps` grows by S a chunk through K10's wrapper,
    and not at all through the plain versions."""
    w_in, w_tree, _, _, points, codes, _, _ = step_inputs(4)
    rng = np.random.default_rng(4)
    walks = torch.from_numpy(rng.integers(0, 60, (96, 8)).astype(np.int32))
    S = 3
    with record() as rec:
        for t0 in (0, S):
            eff = sg.window_draws(torch.Generator().manual_seed(t0),
                                  (S, 2, 128), 3)
            ths.hs_block_chunk(w_in, w_tree, walks, points, codes, eff,
                               0.025, 1e-4, t0, 12.0, block_walks=32,
                               window=3, ops=getattr(ths, ops))
    want = 2 * S if ops == "KERNELS" else 0
    assert rec.counters.get("train.hs_kernel_steps", 0) == want


def test_hs_kernel_steps_equal_a_fits_steps():
    """A single-device hs=1 fit counts every step on K10's route."""
    rng = np.random.default_rng(6)
    walks = torch.from_numpy(rng.integers(0, 40, (64, 10)).astype(np.int32))
    with record() as rec:
        ths.HSTrainer(embed_size=8, window=3, epochs=2, block_walks=16,
                      chunk_steps=2).fit(walks, 40)
    assert rec.counters["train.hs_kernel_steps"] == rec.counters[
        "train.steps"] > 0


@pytest.mark.parametrize("L,window,block_walks", [
    (10, 5, 504), (8, 3, 32), (3, 5, 200), (40, 10, 12), (80, 10, 4),
    (200, 5, 2), (1, 5, 300)])
def test_window_pairs_stay_in_the_walks_dm_marks(L, window, block_walks):
    """K10 finds the walks of a group where dm[0, p] == 0 and scores
    pairs only inside them: so under window_geometry the marked starts
    are the walks' first positions, and window_ok pairs no two positions
    of different walks."""
    geo = sg.block_geometry(10_000, L, block_walks, 1)
    ok, dm = sg.window_geometry(L, geo.PL, window, "cpu")
    starts = torch.nonzero(dm[0] == 0).flatten()
    assert torch.equal(starts, torch.arange(0, geo.PL, L))
    walk = torch.cumsum(dm[0] == 0, 0)
    assert not (ok & (walk[:, None] != walk[None, :])).any()


def emulated(w_in, w_tree, tok, eff, points, codes, window_ok, dm, Q=8,
             CT=16):
    """K10's decomposition written out (csrc/hs.cu): for each group's
    slice of Q positions, the walks starting in it (dm[0, p] == 0) up to
    the next start; each context's centers in ascending order, in tiles of
    CT; its path's levels up to the first -1; each walk's loss at its
    first position."""
    G, PL = tok.shape
    D, T = w_in.shape[1], points.shape[1]
    d_yin = torch.zeros((G * PL, D), dtype=w_in.dtype)
    d_tree = torch.zeros((G * PL * T, D), dtype=w_in.dtype)
    parts = torch.zeros((G, PL), dtype=w_in.dtype)
    for g in range(G):
        tk, ef = tok[g].tolist(), eff[g].tolist()
        for p0 in range(0, PL, Q):
            for s in range(p0, min(p0 + Q, PL)):
                if dm[0, s] != 0:
                    continue
                e = s + 1
                while e < PL and dm[0, e] != 0:
                    e += 1
                loss = 0.0
                for m in range(s, e):
                    tm = tk[m]
                    if tm < 0:
                        continue
                    cent = [l for l in range(s, e) if tk[l] >= 0
                            and window_ok[l, m] and dm[l, m] <= ef[l]]
                    path = points[tm].tolist()
                    dep = path.index(-1) if -1 in path else T
                    for c0 in range(0, len(cent), CT):
                        for l in cent[c0:c0 + CT]:
                            for t in range(dep):
                                row = w_tree[path[t]]
                                x = torch.dot(w_in[tk[l]], row)
                                label = 1.0 - codes[tm, t]
                                gg = label - torch.sigmoid(x)
                                loss += float(F.logsigmoid(
                                    x if label > 0.5 else -x))
                                d_tree[(g * PL + m) * T + t] += gg * w_in[
                                    tk[l]]
                                d_yin[g * PL + l] += gg * row
                parts[g, s] = -loss
    return d_yin, d_tree, parts.sum()


@pytest.mark.parametrize("seed,L,W", [(7, 8, 3), (8, 40, 10), (9, 3, 5)])
def test_kernel_decomposition_gives_the_plain_function(seed, L, W):
    """In float64, K10's decomposition equals the plain version's dense
    products within 1e-12 (L = 40 with window 10 puts up to 20 centers in
    a context: two tiles)."""
    Bw = max(128 // L, 1) * 2
    inputs = step_inputs(seed, V=40, D=6, L=L, Bw=Bw, W=W,
                         dtype=torch.float64)
    for got, want in zip(emulated(*inputs),
                         ohs.hs_block_grads_plain(*inputs)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12,
                                   atol=1e-12)
