"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and skips without one; the file
imports no jax, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_card.py -q

Shapes are those of the DeepWalk-on-Wiki step. Tolerances: the gather is
exact; K1 rtol=2e-4, atol=1e-5 (f32 sums in another order); K2 is
bit-equal to the plain version's sequential sum on the CPU; four SGNS
steps rtol=1e-4, atol=1e-6 (the plain version on the card scatters with
atomics).
"""

import numpy as np
import pytest
import torch

from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.ops.rows import (
    gather_rows,
    gather_rows_plain,
    scatter_add_rows,
    scatter_add_rows_plain,
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
# P = 18), r = 2, K above PL, a single group
@pytest.mark.parametrize("G,PL,D,K,G2", [(336, 120, 128, 64, 84),
                                         (6, 126, 64, 10, 3),
                                         (4, 20, 32, 40, 4),
                                         (1, 9, 4, 1, 1)])
def test_sgns_kernel_matches_plain(cuda, G, PL, D, K, G2):
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
    assert sgns_block_grads.launches == before + 1
    want = sgns_block_grads_plain(*inputs, 5.0 / K)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("V,C,N", [(2405, 257, 40320), (50, 7, 3000),
                                   (10, 1030, 64)])
def test_row_kernels_match_plain(cuda, V, C, N):
    rng = np.random.default_rng(4)
    t = torch.from_numpy(rng.normal(size=(V, C)).astype(np.float32)).to(cuda)
    i = torch.from_numpy(rng.integers(0, V, N).astype(np.int32)).to(cuda)
    g = torch.from_numpy(
        rng.normal(size=(N, C)).astype(np.float32) * 1e-2).to(cuda)
    # a 16-byte-aligned slice (vector loads) and an unaligned one (scalar)
    for cols in (slice(0, C - C % 4), slice(1, C)):
        got = gather_rows(t[:, cols], i)
        assert torch.equal(got, gather_rows_plain(t[:, cols], i))
    bad = i.clone()
    bad[::5] = -3
    bad[1::5] = V
    got = scatter_add_rows(t.clone(), bad, g)
    again = scatter_add_rows(t.clone(), bad, g)
    want = scatter_add_rows_plain(t.cpu(), bad.cpu(), g.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)  # deterministic


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
