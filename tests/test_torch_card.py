"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and skips without one; the file
imports no jax, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_card.py -q

Shapes are those of the DeepWalk-on-Wiki and LINE-on-Wiki steps and of the
row benchmarks. Tolerances: the gathers (K3, K5) are exact; K1 rtol=2e-4,
atol=1e-5 (split-TF32 products, f32 sums in another order) and the same
bits from run to run; K2 and K4 are bit-equal to the plain version's
sequential sum on the CPU and to each other; four SGNS steps rtol=1e-4,
atol=1e-6 and four LINE steps rtol=1e-5, atol=1e-6 (the plain version on
the card scatters with atomics).
"""

import numpy as np
import pytest
import torch

from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.models import line
from graphembedding_tpu_torch.models.line import LINE
from graphembedding_tpu_torch.ops.rows import (
    dma_gather_rows,
    dma_gather_rows_plain,
    gather_rows,
    gather_rows_plain,
    scatter_add_rows,
    scatter_add_rows_plain,
    scatter_add_small,
)
from graphembedding_tpu_torch.ops.sgns import (
    sgns_block_grads,
    sgns_block_grads_plain,
)
from graphembedding_tpu_torch.ops.walk import uniform_walks
from graphembedding_tpu_torch.train import skipgram as sg


@pytest.fixture
def cuda():
    """torch.device('cuda'), or skip where there is no card. Decided when
    the test runs, so every test process collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the slice's shapes, then ragged ones: PL not a multiple of 4 (L = 7,
# P = 18), r = 2, K above PL, a single group; r = 3 at the slice's widths
@pytest.mark.parametrize("G,PL,D,K,G2", [(336, 120, 128, 64, 84),
                                         (6, 126, 64, 10, 3),
                                         (4, 20, 32, 40, 4),
                                         (1, 9, 4, 1, 1),
                                         (12, 120, 128, 64, 4)])
def test_sgns_kernel_matches_plain(cuda, G, PL, D, K, G2):
    """K1 holds rtol=2e-4, atol=1e-5 against the plain version and gives
    the same bits on a second launch (d_vn is summed without atomics)."""
    rng = np.random.default_rng(3)
    f32 = np.float32
    inputs = [torch.from_numpy(a).to(cuda) for a in (
        (rng.standard_normal((G, PL, D)) * 0.3).astype(f32),
        (rng.standard_normal((G, PL, D)) * 0.3).astype(f32),
        (rng.standard_normal((G2, K, D)) * 0.3).astype(f32),
        (rng.random((G, PL, PL)) < 0.2).astype(f32),
        (rng.random((G2, G // G2 * PL, K)) < 0.9).astype(f32))]
    before = sgns_block_grads.launches
    got = sgns_block_grads(*inputs, 5.0 / K)
    again = sgns_block_grads(*inputs, 5.0 / K)
    assert sgns_block_grads.launches == before + 2
    want = sgns_block_grads_plain(*inputs, 5.0 / K)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-4, atol=1e-5)
        assert torch.equal(g, a)


@pytest.mark.parametrize("r", [1, 3, 4])
def test_sgns_kernel_reads_column_slices(cuda, r):
    """yin and yout as the step passes them: the two halves of gathered
    [G, PL, 2D] rows (row stride 2D), vn a column slice of the table."""
    G2, PL, D, K = 8, 120, 128, 64
    G = G2 * r
    gen = torch.Generator(device=cuda).manual_seed(8)
    y = torch.randn((G, PL, 2 * D), generator=gen, device=cuda) * 0.3
    table = torch.randn((G2 * K, 2 * D), generator=gen, device=cuda) * 0.3
    vn = table[:, D:].view(G2, K, D)
    mask = (torch.rand((G, PL, PL), generator=gen, device=cuda)
            < 0.2).float()
    neg_ok = (torch.rand((G2, r * PL, K), generator=gen, device=cuda)
              < 0.9).float()
    args = (y[..., :D], y[..., D:], vn, mask, neg_ok, 5.0 / K)
    got = sgns_block_grads(*args)
    want = sgns_block_grads_plain(*args)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-4, atol=1e-5)


# the DeepWalk step's two scatters (tokens [40320, 257], negatives
# [5376, 129]) into 2,405 rows, the scatter benchmark's V = 1M, ragged ones;
# with a hot row (every fourth id the same) or without
@pytest.mark.parametrize("V,C,N,hot", [(2405, 257, 40320, False),
                                       (2405, 257, 40320, True),
                                       (2405, 129, 5376, False),
                                       (1 << 20, 256, 45696, False),
                                       (50, 7, 3000, False),
                                       (10, 1030, 64, False),
                                       (1, 33, 100, True)])
def test_row_kernels_match_plain(cuda, V, C, N, hot):
    """K3 is table[ids]; K2 is bit-equal to the plain version's sequential
    sum on the CPU and the same from run to run; ids -3, V and V + 100 are
    dropped."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    t = torch.randn((V, C), generator=gen, device=cuda)
    i = torch.randint(0, V, (N,), generator=gen, device=cuda,
                      dtype=torch.int32)
    g = torch.randn((N, C), generator=gen, device=cuda) * 1e-2
    # a 16-byte-aligned slice (vector loads) and an unaligned one (scalar)
    for cols in (slice(0, C - C % 4), slice(1, C)):
        got = gather_rows(t[:, cols], i)
        assert torch.equal(got, gather_rows_plain(t[:, cols], i))
    bad = i.clone()
    if hot:
        bad[3::4] = bad[3]
    bad[::5] = -3
    bad[1::5] = V
    bad[2::11] = V + 100
    before = scatter_add_rows.launches
    got = scatter_add_rows(t.clone(), bad, g)
    again = scatter_add_rows(t.clone(), bad, g)
    assert scatter_add_rows.launches == before + 2
    want = scatter_add_rows_plain(t.cpu(), bad.cpu(), g.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)  # deterministic


# LINE's Wiki scatters (emb, then ctx), the benchmark's shapes, ragged ones:
# C not a multiple of 4, a tile of one row, C above the block's threads
@pytest.mark.parametrize("V,C,N", [(2405, 128, 1024), (2405, 128, 6144),
                                   (10312, 256, 45696), (50, 7, 3000),
                                   (1, 33, 100), (40, 1030, 64)])
def test_scatter_add_small_matches_plain(cuda, V, C, N):
    """K4 is bit-equal to the plain version's sequential sum on the CPU
    and to K2, and the same from run to run; ids -1, V and V + 100 are
    dropped."""
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.normal(size=(V, C)).astype(np.float32)).to(cuda)
    i = rng.integers(0, V, N).astype(np.int32)
    i[::11], i[1::11], i[2::11] = -1, V, V + 100
    i[3::4] = i[3]  # a hot row
    i = torch.from_numpy(i).to(cuda)
    g = torch.from_numpy(
        rng.normal(size=(N, C)).astype(np.float32) * 1e-2).to(cuda)
    before = scatter_add_small.launches
    got = scatter_add_small(t.clone(), i, g)
    again = scatter_add_small(t.clone(), i, g)
    assert scatter_add_small.launches == before + 2
    k2 = scatter_add_rows(t.clone(), i, g)
    want = scatter_add_rows_plain(t.cpu(), i.cpu(), g.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)
    assert torch.equal(got, k2)


@pytest.mark.parametrize("V,W,N,B", [(1 << 20, 256, 1 << 16, 8),
                                     (1 << 20, 256, 1 << 16, 16),
                                     (1 << 20, 256, 1 << 16, 32),
                                     (100, 4, 96, 3), (500, 2048, 64, 16)])
def test_dma_gather_matches_plain(cuda, V, W, N, B):
    """K5 is bit-equal to table[ids] and the same from run to run; an id
    outside [0, V) gives a zero row."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    t = torch.randn((V, W), generator=gen, device=cuda)
    i = torch.randint(0, V, (N,), generator=gen, device=cuda,
                      dtype=torch.int32)
    before = dma_gather_rows.launches
    got = dma_gather_rows(t, i, block_rows=B)
    assert torch.equal(got, dma_gather_rows_plain(t, i))
    assert torch.equal(got, dma_gather_rows(t, i, block_rows=B))
    assert dma_gather_rows.launches == before + 2
    bad = i.clone()
    bad[::5] = -1
    bad[1::5] = V
    got = dma_gather_rows(t, bad, block_rows=B)
    ok = (bad >= 0) & (bad < V)
    assert torch.equal(got[ok], t[bad[ok].long()])
    assert not got[~ok].any()


@pytest.mark.parametrize("order,k_shared", [("first", 0), ("second", 0),
                                            ("second", 64)])
def test_four_line_steps_match_plain(cuda, order, k_shared):
    """Four LINE steps at the Wiki shapes through K3 and K4 against the
    plain versions, from the same tables and draws: rtol=1e-5, atol=1e-6
    (the plain scatter on the card sums with atomics, in another order)."""
    V, D, B, K = 2405, 128, 1024, 5
    g = Graph(np.arange(V), (np.arange(V) * 7 + 1) % V, directed=False)
    m = LINE(g, embedding_size=D, order=order, k_shared=k_shared,
             device=cuda)
    draws = line.line_bulk_samples(
        m._edge_src, m._edge_dst, m._edge_accept, m._edge_alias,
        m._neg_table, torch.Generator(device=cuda).manual_seed(7), 0.025, 0,
        796.0, chunk_steps=4, batch_size=B, negative=K, k_shared=k_shared)
    emb, ctx = ((m.first_emb, None) if order == "first"
                else (m.second_emb, m.context_emb))
    out = []
    for ops in (line.KERNELS, line.PLAIN):
        out.append(line.line_steps(
            emb.clone(), None if ctx is None else ctx.clone(), *draws,
            negative=K, k_shared=k_shared, ops=ops))
    torch.cuda.synchronize()
    for a, b in zip(out[0], out[1]):
        if a is not None:
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                       rtol=1e-5, atol=1e-6)
    assert (out[0][0] - emb).abs().max() > 1e-4  # it moved


def test_walks_on_card(cuda):
    g = Graph(np.array([0, 1, 2, 2]), np.array([1, 2, 0, 3]), directed=False)
    dg = g.to(cuda)
    gen = torch.Generator(device=cuda).manual_seed(2)
    walks = uniform_walks(dg.row_ptr, dg.col_idx, dg.degree,
                          torch.full((20000,), 2, device=cuda), length=2,
                          generator=gen).cpu().numpy()
    freq = np.bincount(walks[:, 1], minlength=4) / walks.shape[0]
    np.testing.assert_allclose(freq[[0, 1, 3]], 1 / 3, atol=0.02)


def test_four_steps_match_plain(cuda):
    V, D, L, NW, Bw, K = 2405, 128, 10, 16128, 4032, 64
    gen = torch.Generator(device=cuda).manual_seed(12)
    walks = torch.randint(0, V, (NW, L), generator=gen, device=cuda,
                          dtype=torch.int32)
    walks[::7, 6:] = -1  # dead-ended walks
    geo = sg.block_geometry(NW, L, Bw, 4)
    eff = 5 - (torch.rand((4, geo.G, geo.PL), generator=gen, device=cuda)
               * 5).to(torch.int32).clamp(0, 4)
    negs = torch.randint(0, V, (4, geo.G2, K), generator=gen, device=cuda,
                         dtype=torch.int32)
    w0 = (torch.rand((V, 2 * D), generator=gen, device=cuda) - 0.5) / D
    kw = dict(block_walks=Bw, window=5, negative=5, neg_share_packs=4)
    a, la, _ = sg.sgns_block_chunk_cat(w0.clone(), walks, eff, negs, 0.025,
                                       1e-4, 0, 192.0, **kw)
    b, lb, _ = sg.sgns_block_chunk_cat(w0.clone(), walks, eff, negs, 0.025,
                                       1e-4, 0, 192.0, ops=sg.PLAIN, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(la.cpu().numpy(), lb.cpu().numpy(),
                               rtol=1e-4)
