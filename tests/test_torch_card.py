"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs an NVIDIA card and skips without one; the file
imports no jax, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_card.py -q

Shapes are those of the DeepWalk-on-Wiki (SGNS and hs=1) and LINE-on-Wiki
steps, of the row benchmarks and of Struc2Vec's walk on flight-brazil.
Tolerances: the gathers (K3, K5) are exact; K1 rtol=2e-4, atol=1e-5
(split-TF32 products, f32 sums in another order) and the same bits from
run to run; K2 and K4 are bit-equal to the plain version's sequential sum
on the CPU and to each other; four SGNS steps (either cap) and four HS
steps with the sparse cap rtol=1e-4, atol=1e-6, four LINE steps and four
HS steps with the dense cap rtol=1e-5, atol=1e-6 (the plain version on
the card scatters with atomics); the multilayer walk is bit-identical from
one seed; a resumed train is bit-identical to an uninterrupted one, and
`most_similar` on the card gives the numpy path's names (apart from ties)
and scores within 1e-5. SDNE's three trainers and the dense expected-SGNS
fit run no kernel of the port's; their steps on the card are bit-identical from run
to run, torch.equal through the chunk graphs and launched one by one, and
agree with the same steps on the CPU: losses rtol=1e-5, and
each parameter's update (value minus the shared initial value) within
1e-3 of the CPU's in L2 norm. Adam's step is about lr * grad / (|grad| +
eps), so an element whose gradient is near zero turns the last-bit
differences of another summation order into a step of up to lr, and no
elementwise bound holds. The co-occurrence matrix and LINE's dense
adjacency equal the CPU's; its q = wdeg^0.75 (sums in another order)
holds rtol=1e-6. The row-sharded SGNS chunk at world size 1 over NCCL (a
spawned rank) equals the single-device chunk bit for bit, with K3 once, K1
once and K2 twice a step; each mesh trainer's chunks there (rowshard with
prefetch off and on, dp SGNS, HS and LINE, SDNE full batch and sparse)
through their CUDA graphs, the NCCL exchanges inside, equal the same steps
launched one by one, with the same launches. Each walk kernel (K6-K9,
csrc/walk.cu) walks exactly its plain version's corpus on the uniforms
that version draws (`draws=`), one launch a corpus; from a seed (Philox) it
walks the same corpus twice, every hop an edge, -1 after a dead end, and
its third hop on the weighted triangle with a tail follows the exact law
within atol 0.03.
"""

import functools

import numpy as np
import pytest
import torch

from graphembedding_tpu_torch.data import load_dataset, synthetic_wiki
from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.models import SDNE
from graphembedding_tpu_torch.models import line
from graphembedding_tpu_torch.models import struc2vec as s2v
from graphembedding_tpu_torch.models.line import LINE
from graphembedding_tpu_torch.ops.rows import (
    dma_gather_plan,
    dma_gather_rows,
    dma_gather_rows_plain,
    gather_rows,
    gather_rows_plain,
    scatter_add_rows,
    scatter_add_rows_plain,
    scatter_add_small,
    sm_count,
    SMALL_V_ROWS,
)
from graphembedding_tpu_torch.ops.hs import (
    hs_block_grads,
    hs_block_grads_plain,
)
from graphembedding_tpu_torch.ops.sgns import (
    sgns_block_grads,
    sgns_block_grads_plain,
)
from graphembedding_tpu_torch.ops import walk
from graphembedding_tpu_torch.ops.walk import simulate_walks, uniform_walks
from graphembedding_tpu_torch.train import dense
from graphembedding_tpu_torch.train import hsoftmax as hs
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


def huffman_path_ids(rng, v=2405, tokens=5040):
    """The tree rows of the hierarchical-softmax step's scatter: the
    Huffman paths (root first, -1 padded) of `tokens` tokens drawn from
    Zipf-like counts over v nodes, a tenth of the tokens pads."""
    counts = np.floor(1e4 / np.arange(1, v + 1))
    points, _, _ = hs.build_huffman(counts)
    tok = rng.choice(v, tokens, p=counts / counts.sum())
    ids = points[tok]
    ids[rng.random(tokens) < 0.1] = -1
    return ids.reshape(-1).astype(np.int32)


# LINE's Wiki scatters (emb, then ctx), the benchmark's shapes, ragged ones:
# C not a multiple of 4, a tile of one row, C above the block's threads;
# then the HS tree's Huffman paths, one row taking every id, every id
# dropped, V = 1 and SMALL_V_ROWS, C of 1 to 256, grads at an address
# that is not 16-byte aligned, and a column slice of a wider table
@pytest.mark.parametrize("plan", [None, "scan", "group"])
@pytest.mark.parametrize("V,C,N,case", [
    (2405, 128, 1024, "hot"), (2405, 128, 6144, "hot"),
    (10312, 256, 45696, "hot"), (50, 7, 3000, "hot"), (1, 33, 100, "hot"),
    (40, 1030, 64, "hot"), (2404, 128, 70560, "huffman"),
    (300, 128, 5000, "one_row"), (300, 64, 2000, "dropped"),
    (1, 128, 3000, "hot"), (SMALL_V_ROWS, 128, 45696, "hot"),
    (2405, 1, 6144, "hot"), (2405, 4, 6144, "hot"), (2405, 129, 6144, "hot"),
    (2405, 256, 6144, "hot"), (2405, 128, 6144, "unaligned"),
    (2405, 128, 6144, "slice")])
def test_scatter_add_small_matches_plain(cuda, V, C, N, case, plan):
    """K4, by either plan or its rule's, is bit-equal to the plain
    version's sequential sum on the CPU and to K2, and the same from run
    to run; ids -1, V and V + 100 are dropped."""
    rng = np.random.default_rng(5)
    t = torch.from_numpy(rng.normal(size=(V, C)).astype(np.float32)).to(cuda)
    if case == "huffman":
        i = huffman_path_ids(rng, V + 1, N // 14)
        N = i.size
    else:
        i = rng.integers(0, V, N).astype(np.int32)
        i[::11], i[1::11], i[2::11] = -1, V, V + 100
        i[3::4] = i[3]  # a hot row
        if case == "one_row":
            i[:] = 7
        elif case == "dropped":
            i = np.where(np.arange(N) % 2, -5, V + np.arange(N)).astype(
                np.int32)
    i = torch.from_numpy(i).to(cuda)
    g = torch.from_numpy(
        rng.normal(size=(N, C)).astype(np.float32) * 1e-2).to(cuda)
    if case == "unaligned":  # 4 bytes past a 16-byte boundary
        g = torch.cat([torch.zeros(1, device=cuda), g.reshape(-1)])[1:]
        g = g.view(N, C)
        assert g.data_ptr() % 16 == 4 and g.is_contiguous()
    wide = t
    if case == "slice":  # the columns 4 .. 4 + C of a [V, C + 12] table
        wide = torch.from_numpy(rng.normal(size=(V, C + 12)).astype(
            np.float32)).to(cuda)
        t = wide[:, 4:4 + C]
    before = scatter_add_small.launches

    def k4():
        out = wide.clone()
        scatter_add_small(out[:, 4:4 + C] if case == "slice" else out, i,
                          g, plan=plan)
        return out

    got, again = k4(), k4()
    assert scatter_add_small.launches == before + 2
    k2 = wide.clone()
    scatter_add_rows(k2[:, 4:4 + C] if case == "slice" else k2, i, g)
    want = wide.cpu()
    scatter_add_rows_plain(want[:, 4:4 + C] if case == "slice" else want,
                           i.cpu(), g.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)
    assert torch.equal(got, k2)
    if case != "dropped":
        assert not torch.equal(got, wide)  # it moved


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


# the ring wrapped many times (N / B far above grid x S), fewer stages than
# blocks a card holds, one row a stage, 256 rows of 16 bytes a stage, all
# ids outside [0, V), one hot row, a one-stage ring wrapped
@pytest.mark.parametrize("V,W,N,B,case", [
    (4096, 256, 1 << 20, 8, "wraps"), (1000, 256, 160, 16, "few"),
    (777, 8, 3001, 1, "b1"), (5000, 4, 256 * 600, 256, "b256"),
    (1 << 20, 256, 1 << 16, 16, "pads"), (2405, 256, 40320, 16, "hot"),
    (500, 2048, 16 * 132 * 12, 16, "s1")])
def test_dma_gather_ring(cuda, V, W, N, B, case):
    """K5's ring of stages: bit-equal to table[ids] and the same from run
    to run however often a slot is reused; every id outside [0, V) gives
    zero rows; every id one hot row gives copies of it."""
    stages, grid, _ = dma_gather_plan(N, W, B, sm_count(cuda.index or 0))
    if case == "wraps":  # each slot reused some 20 times
        assert N // B >= 40 * grid * stages
    if case == "s1":  # a ring of one 128 KB stage, reused by each block
        assert stages == 1 and N // B >= 10 * grid
    if case == "few":
        assert grid == N // B < sm_count(cuda.index or 0)
    gen = torch.Generator(device=cuda).manual_seed(9)
    t = torch.randn((V, W), generator=gen, device=cuda)
    i = torch.randint(0, V, (N,), generator=gen, device=cuda,
                      dtype=torch.int32)
    if case == "pads":
        i = torch.where(i % 2 == 0, -1 - i, V + i)
    if case == "hot":
        i.fill_(V // 3)
    before = dma_gather_rows.launches
    got = dma_gather_rows(t, i, block_rows=B)
    again = dma_gather_rows(t, i, block_rows=B)
    assert dma_gather_rows.launches == before + 2
    torch.cuda.synchronize()
    if case == "pads":
        assert not got.any()
    else:
        assert torch.equal(got, dma_gather_rows_plain(t, i))
    assert torch.equal(got, again)


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


def test_views_shared_by_card_names(cuda):
    """'cuda' and 'cuda:<current>' name one card and share its views."""
    g = Graph(np.array([0, 1, 2]), np.array([1, 2, 0]))
    here = torch.device("cuda", torch.cuda.current_device())
    assert g.to(cuda) is g.to(here)
    assert g.neighbor_ids(cuda) is g.neighbor_ids(here)


@pytest.mark.parametrize("kind,sampler", [
    ("weighted", None), ("node2vec", "exact"),
    ("node2vec", "rejection_dense"), ("node2vec", "rejection")])
def test_weighted_and_pq_walks_on_card(cuda, kind, sampler):
    """The third hop from 0 through 1 on a weighted triangle with a tail
    follows its exact law (p = 0.25, q = 4; weighted: the edge weights),
    and one seed gives the same walks twice."""
    src, dst = np.array([0, 1, 2, 2]), np.array([1, 2, 0, 3])
    w = np.array([3.0, 1.0, 2.0, 0.5], dtype=np.float32)
    g = Graph(src, dst, w, directed=False)

    def run():
        gen = torch.Generator(device=cuda).manual_seed(4)
        return simulate_walks(g, 30000, 3, generator=gen, kind=kind, p=0.25,
                              q=4.0, sampler=sampler)

    walks = run()
    assert torch.equal(walks, run())
    walks = walks.cpu().numpy()
    sel = walks[(walks[:, 0] == 0) & (walks[:, 1] == 1)]
    # from 1, having come from 0: N(1) = {0 (w 3), 2 (w 1)}, and 2 is in
    # N(0), so the (p,q) factors are 1/p for 0 and 1 for 2
    target = np.array([3.0, 1.0]) if kind == "weighted" else \
        np.array([3.0 / 0.25, 1.0])
    freq = np.bincount(sel[:, 2], minlength=4)[[0, 2]] / len(sel)
    assert len(sel) > 2000
    np.testing.assert_allclose(freq, target / target.sum(), atol=0.03)


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


@pytest.mark.parametrize("V", [2405, 200_000])
def test_four_sparse_cap_steps_match_plain(cuda, V):
    """Four steps with the sparse cap (`sparse_capped_update`) through
    K1-K3 against the plain versions from the same table and draws, at
    Wiki's V and at one where K2 sorts by radix: rtol 1e-4, atol 1e-6, as
    the dense steps; K3 twice, K1 once and K2 three times a step (the
    negatives' occupancy, the tokens' rows, the negatives' rows)."""
    D, L, Bw, K = 128, 10, 4032, 64
    NW = max(16128, 5 * V)
    gen = torch.Generator(device=cuda).manual_seed(13)
    walks = torch.randint(0, V, (NW, L), generator=gen, device=cuda,
                          dtype=torch.int32)
    walks[::7, 6:] = -1  # dead-ended walks
    walks[:64, 0] = 0  # row 0 beside pads
    geo = sg.block_geometry(NW, L, Bw, 4)
    eff = 5 - (torch.rand((4, geo.G, geo.PL), generator=gen, device=cuda)
               * 5).to(torch.int32).clamp(0, 4)
    negs = torch.randint(0, V, (4, geo.G2, K), generator=gen, device=cuda,
                         dtype=torch.int32)
    w0 = (torch.rand((V, 2 * D), generator=gen, device=cuda) - 0.5) / D
    kw = dict(block_walks=Bw, window=5, negative=5, neg_share_packs=4,
              sparse_cap=True)
    kernels = (gather_rows, sgns_block_grads, scatter_add_rows)
    before = [k.launches for k in kernels]
    a, la, pa = sg.sgns_block_chunk_cat(w0.clone(), walks, eff, negs, 0.025,
                                        1e-4, 0, 192.0, **kw)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [8, 4, 12]
    b, lb, pb = sg.sgns_block_chunk_cat(w0.clone(), walks, eff, negs, 0.025,
                                        1e-4, 0, 192.0, ops=sg.PLAIN, **kw)
    torch.cuda.synchronize()
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(la.cpu().numpy(), lb.cpu().numpy(),
                               rtol=1e-4)
    assert torch.equal(pa, pb)
    assert float((a - w0).abs().max()) > 1e-4


def rowshard_world1_rank(info, S):
    """In a spawned NCCL rank of world size 1: the DeepWalk-on-Wiki shapes'
    chunk by `rowsharded_sgns_chunk` and by `sgns_block_chunk_cat` on the
    same table and draws; (tables equal, losses and pairs equal, launches
    of the row-sharded chunk)."""
    from graphembedding_tpu_torch.parallel import make_mesh
    from graphembedding_tpu_torch.parallel.rowshard import (
        rowsharded_sgns_chunk,
    )

    dev = info.device
    V, D, L, NW, Bw, K = 2405, 128, 10, 16128, 4032, 64
    gen = torch.Generator(device=dev).manual_seed(12)
    walks = torch.randint(0, V, (NW, L), generator=gen, device=dev,
                          dtype=torch.int32)
    walks[::7, 6:] = -1  # dead-ended walks
    geo = sg.block_geometry(NW, L, Bw, 4)
    eff = 5 - (torch.rand((S, geo.G, geo.PL), generator=gen, device=dev)
               * 5).to(torch.int32).clamp(0, 4)
    negs = torch.randint(0, V, (S, geo.G2, K), generator=gen, device=dev,
                         dtype=torch.int32)
    w0 = (torch.rand((V, 2 * D), generator=gen, device=dev) - 0.5) / D
    kw = dict(block_walks=Bw, window=5, negative=5, neg_share_packs=4)
    a, la, pa = sg.sgns_block_chunk_cat(w0.clone(), walks, eff, negs, 0.025,
                                        1e-4, 3, 192.0, **kw)
    kernels = (gather_rows, sgns_block_grads, scatter_add_rows)
    for k in kernels:
        k.launches = 0
    b, lb, pb = rowsharded_sgns_chunk(
        w0.clone(), walks, eff, negs, 0.025, 1e-4, 3, 192.0,
        mesh=make_mesh((1, 1), device=dev), **kw)
    torch.cuda.synchronize()
    return (torch.equal(a, b), torch.equal(la, lb), torch.equal(pa, pb),
            {k.__name__: k.launches for k in kernels})


def test_rowshard_world1_nccl_equals_single_device(cuda):
    from graphembedding_tpu_torch.parallel.launch import run_ranks

    S = 4
    [(tables, losses, pairs, launches)] = run_ranks(
        rowshard_world1_rank, 1, S, backend="nccl", device="cuda:0",
        timeout_s=300)
    assert tables and losses and pairs
    assert launches == {"gather_rows": S, "sgns_block_grads": S,
                        "scatter_add_rows": 2 * S}



def riding_hs_step(w_in, w_tree, tok, eff_b, points, codes, lr, *,
                   window_ok, dm, update_cap, ops):
    """`train.hsoftmax.hs_step` as it was with the occupancy riding as a
    last gradient column ([N, D + 1] scatters, D + 1 = 129 at the slice),
    its gradients and loss from the same `ops.block_grads` (K10 under the
    kernels), kept here to hold the step with the occupancy apart against
    it bit for bit (here on the card, tests/test_torch_hsoftmax.py on the
    CPU)."""
    V, D = w_in.shape
    tok_ok = tok >= 0
    tok_safe = torch.where(tok_ok, tok, 0)
    pts = points[tok_safe]
    pts_ok = (pts >= 0) & tok_ok[:, :, None]
    mask = (window_ok[None] & (dm[None] <= eff_b[:, :, None])
            & tok_ok[:, :, None] & tok_ok[:, None, :]).to(torch.float32)
    d_yin, d_tree, nll = ops.block_grads(w_in, w_tree, tok, eff_b, points,
                                         codes, window_ok, dm)
    n_pairs_ctx = mask.sum(1)
    tweight = (n_pairs_ctx[:, :, None] * pts_ok).reshape(-1, 1)
    ones = torch.ones((tok.numel(), 1), dtype=torch.float32,
                      device=w_in.device)
    tbuf = ops.scatter_add(
        torch.zeros((V, D + 1), dtype=torch.float32, device=w_in.device),
        tok.reshape(-1), torch.cat([d_yin, ones], 1))
    tbuf[0, D] += (tok < 0).sum()
    rbuf = ops.scatter_add(
        torch.zeros((w_tree.shape[0], D + 1), dtype=torch.float32,
                    device=w_in.device),
        torch.where(pts_ok, pts, -1).reshape(-1),
        torch.cat([d_tree, tweight], 1))
    tok_scale = (update_cap / tbuf[:, D:].clamp(min=1.0)).clamp(max=1.0)
    tree_scale = (update_cap / rbuf[:, D:].clamp(min=1.0)).clamp(max=1.0)
    w_in.add_(lr * tbuf[:, :D] * tok_scale)
    w_tree.add_(lr * rbuf[:, :D] * tree_scale)
    pairs = mask.sum()
    return nll / pairs.clamp(min=1.0), pairs


def hs_tree_ids(rng, n=70_560, v=2404, T=14):
    """Ids like the DeepWalk hs=1 step's tree scatter: G * PL contexts of T
    levels, each path starting at the root (row 0: a run of 5,040), about a
    third of the slots pads (-1)."""
    ids = rng.integers(1, v, n).astype(np.int32)
    ids[::T] = 0
    ids[rng.random(n) < 0.3] = -1
    return ids


@pytest.mark.parametrize("C", [129, 128])
@pytest.mark.parametrize("kernel", ["K4", "K2", "K4 scan", "K4 group"])
def test_hs_tree_scatter_matches_plain(cuda, kernel, C):
    """K4 (by its rule, or either plan) and K2 at the HS tree scatter's
    shape (70,560 ids into 2,404 rows; C = 128, or 129 with an occupancy
    column last): bit-equal to the plain version's sequential sum on the
    CPU and to each other, the same from run to run."""
    rng = np.random.default_rng(13)
    ids = torch.from_numpy(hs_tree_ids(rng)).to(cuda)
    grads = rng.normal(size=(ids.numel(), C)).astype(np.float32) * 1e-2
    if C == 129:
        grads[:, -1] = rng.integers(0, 11, ids.numel())
    grads = torch.from_numpy(grads).to(cuda)
    table = torch.zeros((2404, C), device=cuda)
    plan = kernel.split()[1] if " " in kernel else None
    fn = scatter_add_rows if kernel == "K2" else functools.partial(
        scatter_add_small, plan=plan)
    counter = scatter_add_rows if kernel == "K2" else scatter_add_small
    before = counter.launches
    got = fn(table.clone(), ids, grads)
    again = fn(table.clone(), ids, grads)
    assert counter.launches == before + 2
    other = (scatter_add_small if kernel == "K2" else scatter_add_rows)(
        table.clone(), ids, grads)
    want = scatter_add_rows_plain(table.cpu(), ids.cpu(), grads.cpu())
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)
    assert torch.equal(got, other)


def test_hs_tree_gather(cuda):
    """K3 at the HS tree gather's shape: 70,560 ids (pads read as row 0)
    of a [2404, 128] table, bit-exact."""
    rng = np.random.default_rng(14)
    ids = torch.from_numpy(hs_tree_ids(rng).clip(min=0)).to(cuda)
    table = torch.randn((2404, 128), device=cuda)
    before = gather_rows.launches
    got = gather_rows(table, ids)
    assert gather_rows.launches == before + 1
    assert torch.equal(got, gather_rows_plain(table, ids))


def hs_kernel_inputs(dev, *, V, D, L, G, W, T, seed, scale=1.0):
    """A hs=1 step's inputs for K10: G groups of P = max(128 // L, 1)
    walks of L (every 7th dead-ended after 6 tokens, holes as subsampling
    leaves them), window draws in {1..W}, paths of 1..T levels (-1
    padded, the first T deep) with 0/1 codes, w_in as a fit starts it and
    w_tree ~ N(0, 0.05), both times `scale`."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    P = max(128 // L, 1)
    PL = P * L
    tok = torch.randint(0, V, (G * P, L), generator=gen, device=dev,
                        dtype=torch.int32)
    tok[::7, min(6, L - 1):] = -1  # dead-ended walks
    tok[3::11, L // 2] = -1  # holes
    tok = tok.reshape(G, PL)
    eff = sg.window_draws(gen, (G, PL), W)
    depth = torch.randint(1, T + 1, (V,), generator=gen, device=dev)
    depth[0] = T
    on = torch.arange(T, device=dev)[None] < depth[:, None]
    points = torch.where(on, torch.randint(
        0, V - 1, (V, T), generator=gen, device=dev, dtype=torch.int32),
        -1).to(torch.int32)
    codes = ((torch.rand((V, T), generator=gen, device=dev) < 0.5)
             & on).float()
    w_in = (torch.rand((V, D), generator=gen, device=dev) - 0.5) / D * scale
    w_tree = torch.randn((V - 1, D), generator=gen, device=dev) * (
        0.05 * scale)
    ok, dm = sg.window_geometry(L, PL, W, dev)
    return w_in, w_tree, tok, eff, points, codes, ok, dm


# the Wiki step, the BlogCatalog and YouTube cells' steps (T = 15, 21),
# a deep tree, D not 128 (16-byte and 4-byte rows), more centers a
# context than a tile holds (L = 40, window 10), one walk a group (L = 80),
# a window longer than the walk (L = 3), logits far from 0
HS_KERNEL_CASES = {
    "wiki": dict(V=2405, D=128, L=10, G=42, W=5, T=14),
    "blogcatalog": dict(V=10_312, D=128, L=10, G=42, W=5, T=15),
    "youtube": dict(V=1_138_499, D=128, L=10, G=42, W=5, T=21),
    "deep": dict(V=4000, D=128, L=10, G=42, W=5, T=44),
    "d100": dict(V=2405, D=100, L=10, G=42, W=5, T=14),
    "d30": dict(V=500, D=30, L=10, G=8, W=5, T=9),
    "long walks": dict(V=3000, D=64, L=40, G=6, W=10, T=12),
    "one walk a group": dict(V=3000, D=128, L=80, G=4, W=10, T=12),
    "short walks": dict(V=700, D=32, L=3, G=4, W=5, T=10),
    "saturated": dict(V=2405, D=128, L=10, G=42, W=5, T=14, scale=40.0),
}


@pytest.mark.parametrize("case", sorted(HS_KERNEL_CASES))
def test_hs_kernel_matches_plain(cuda, case):
    """K10 against its plain version (full float32 bmm): d_yin and d_tree
    rtol 1e-5 with atol 2e-6 of the largest entry, the loss rtol 1e-5
    (sums in another order); rows no pair reaches (pads, levels past a
    path) exactly zero; the same bits on a second launch; one launch a
    call."""
    inputs = hs_kernel_inputs(cuda, seed=21, **HS_KERNEL_CASES[case])
    before = hs_block_grads.launches
    got = hs_block_grads(*inputs)
    again = hs_block_grads(*inputs)
    assert hs_block_grads.launches == before + 2
    want = hs_block_grads_plain(*inputs)
    torch.cuda.synchronize()
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for g, w in zip(got[:2], want[:2]):
        w = w.cpu().numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=1e-5,
                                   atol=2e-6 * float(np.abs(w).max()))
    np.testing.assert_allclose(float(got[2]), float(want[2]), rtol=1e-5)
    _, _, tok, _, points, _, _, _ = inputs
    tok_ok = tok >= 0
    reach = (points[torch.where(tok_ok, tok, 0)] >= 0) & tok_ok[..., None]
    assert not got[1][~reach.reshape(-1)].any()
    assert not got[0][~tok_ok.reshape(-1)].any()
    assert float(got[0].abs().sum()) > 0 and float(got[1].abs().sum()) > 0


def test_hs_kernel_refuses_what_it_does_not_take(cuda):
    """The wrapper raises on a CPU tensor beside CUDA ones, a wrong dtype,
    a non-contiguous input and a shape beyond 227 KB of shared memory."""
    inputs = list(hs_kernel_inputs(cuda, seed=22, **HS_KERNEL_CASES["wiki"]))
    for i, bad in ((2, inputs[2].cpu()), (3, inputs[3].long()),
                   (5, inputs[5].t().contiguous().t())):
        args = list(inputs)
        args[i] = bad
        with pytest.raises(ValueError):
            hs_block_grads(*args)
    args = list(inputs)
    args[0] = torch.zeros((2405, 2048), device=cuda)
    args[1] = torch.zeros((2404, 2048), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        hs_block_grads(*args)


def test_four_hs_steps_match_plain(cuda):
    """Four HS steps at the DeepWalk hs=1 Wiki widths (Bw = 504: G = 42
    groups of PL = 120, D = 128, V = 2405) through K10 and K4 against the
    plain versions, from the same tables and draws: rtol 1e-5, atol 1e-6;
    a step launches K10 once and K4 twice, and no K3 (K10 reads the tree
    rows itself)."""
    V, D, L, NW, W = 2405, 128, 10, 5040, 5
    gen = torch.Generator(device=cuda).manual_seed(15)
    walks = torch.randint(0, V, (NW, L), generator=gen, device=cuda,
                          dtype=torch.int32)
    walks[::7, 6:] = -1  # dead-ended walks
    points, codes, _ = hs.build_huffman(sg.corpus_counts(walks, V))
    points = torch.as_tensor(points, device=cuda)
    codes = torch.as_tensor(codes, device=cuda)
    geo = sg.block_geometry(NW, L, 504, 1)
    eff = W - (torch.rand((4, geo.G, geo.PL), generator=gen, device=cuda)
               * W).to(torch.int32).clamp(0, W - 1)
    w_in = (torch.rand((V, D), generator=gen, device=cuda) - 0.5) / D
    w_tree = torch.randn((V - 1, D), generator=gen, device=cuda) * 0.05
    kernels = (hs_block_grads, gather_rows, scatter_add_small)
    before = [k.launches for k in kernels]
    out = [hs.hs_block_chunk(w_in.clone(), w_tree.clone(), walks, points,
                             codes, eff, 0.025, 1e-4, 0, 1152.0,
                             block_walks=504, window=W, ops=ops)
           for ops in (hs.KERNELS, hs.PLAIN)]
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 0, 8]
    torch.cuda.synchronize()
    for a, b in zip(out[0][:3], out[1][:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    assert torch.equal(out[0][3], out[1][3])
    assert (out[0][1] - w_tree).abs().max() > 1e-4  # it moved



def test_hs_step_equals_riding_column_form_on_card(cuda):
    """Four HS steps at the DeepWalk hs=1 Wiki widths through the kernels
    (K10, K4) with the occupancy apart equal four steps of the form in
    which it rode as a last gradient column ([N, 129] scatters), bit for
    bit: w_in, w_tree, the losses and the pair counts, both forms taking
    their gradients from K10."""
    V, D, L, NW, W = 2405, 128, 10, 5040, 5
    gen = torch.Generator(device=cuda).manual_seed(16)
    walks = torch.randint(0, V, (NW, L), generator=gen, device=cuda,
                          dtype=torch.int32)
    walks[::7, 6:] = -1
    points, codes, _ = hs.build_huffman(sg.corpus_counts(walks, V))
    points = torch.as_tensor(points, device=cuda)
    codes = torch.as_tensor(codes, device=cuda)
    geo = sg.block_geometry(NW, L, 504, 1)
    ok, dm = sg.window_geometry(L, geo.PL, W, cuda)
    eff = W - (torch.rand((4, geo.G, geo.PL), generator=gen, device=cuda)
               * W).to(torch.int32).clamp(0, W - 1)
    w_in = (torch.rand((V, D), generator=gen, device=cuda) - 0.5) / D
    w_tree = torch.randn((V - 1, D), generator=gen, device=cuda) * 0.05
    outs = []
    for step in (hs.hs_step, riding_hs_step):
        a, b, res = w_in.clone(), w_tree.clone(), []
        with hs.f32_matmul():
            for s in range(4):
                tok = walks[s * geo.Bw:(s + 1) * geo.Bw].reshape(geo.G,
                                                                 geo.PL)
                res.append(step(a, b, tok, eff[s], points, codes,
                                0.025, window_ok=ok, dm=dm, update_cap=8.0,
                                ops=hs.KERNELS))
        outs.append((a, b, torch.stack([r[0] for r in res]),
                     torch.stack([r[1] for r in res])))
    torch.cuda.synchronize()
    for x, y in zip(*outs):
        assert torch.equal(x, y)
    assert (outs[0][1] - w_tree).abs().max() > 1e-4

@pytest.mark.parametrize("V", [2405, 200_000])
def test_four_sparse_hs_steps_match_plain(cuda, V):
    """Four HS steps with the sparse cap (`hs.sparse_capped_update`: the
    pre-scaled rows scattered into the live tables) at the DeepWalk hs=1
    Wiki widths through K10 and K4 (V = 2405, within SMALL_V_ROWS) or K2
    (V = 200,000, above it) against the plain versions, from the same
    tables and draws: rtol 1e-4, atol 1e-6 (the sparse form's parity
    tolerance); one K10 launch, no K3 and two scatter launches a step."""
    D, L, W = 128, 10, 5
    NW = max(5040, V)
    gen = torch.Generator(device=cuda).manual_seed(17)
    walks = torch.randint(0, V, (NW, L), generator=gen, device=cuda,
                          dtype=torch.int32)
    walks[::7, 6:] = -1  # dead-ended walks
    walks[:64, 0] = 0  # row 0 beside pads
    points, codes, _ = hs.build_huffman(sg.corpus_counts(walks, V))
    points = torch.as_tensor(points, device=cuda)
    codes = torch.as_tensor(codes, device=cuda)
    geo = sg.block_geometry(NW, L, 504, 1)
    eff = sg.window_draws(gen, (4, geo.G, geo.PL), W)
    w_in = (torch.rand((V, D), generator=gen, device=cuda) - 0.5) / D
    w_tree = torch.randn((V - 1, D), generator=gen, device=cuda) * 0.05
    scatter = scatter_add_small if V <= SMALL_V_ROWS else scatter_add_rows
    kernels = (hs_block_grads, gather_rows, scatter)
    before = [k.launches for k in kernels]
    out = [hs.hs_block_chunk(w_in.clone(), w_tree.clone(), walks, points,
                             codes, eff, 0.025, 1e-4, 0, 1152.0,
                             block_walks=504, window=W, sparse_cap=True,
                             ops=ops)
           for ops in (hs.KERNELS, hs.PLAIN)]
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kernels, before)] == [4, 0, 8]
    for a, b in zip(out[0][:3], out[1][:3]):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-4, atol=1e-6)
    assert torch.equal(out[0][3], out[1][3])
    assert (out[0][1] - w_tree).abs().max() > 1e-4  # it moved


def test_multilayer_walks_on_card(cuda):
    """Struc2Vec's walk on flight-brazil's context graph: bit-identical
    from one seed, every hop an edge of some layer or a stay."""
    g = load_dataset("flight-brazil").graph
    layers = s2v.build_layer_csr(s2v.build_context_graph(g)[0],
                                 g.num_nodes)
    ly = s2v.layers_to(layers, cuda)
    V = g.num_nodes
    starts = torch.arange(V, dtype=torch.int32, device=cuda).repeat(80)

    def run():
        gen = torch.Generator(device=cuda).manual_seed(3)
        return s2v.multilayer_walks(ly["row_ptr"], ly["col_idx"],
                                    ly["accept"], ly["alias"], ly["gamma"],
                                    starts, gen, 0.3, length=10)

    walks = run()
    assert torch.equal(walks, run())
    w = walks.cpu().numpy().astype(np.int64)
    rp = layers["row_ptr"].astype(np.int64)
    deg = np.diff(rp, axis=1)
    keys = np.concatenate([np.repeat(np.arange(V), deg[k]) * V
                           + layers["col_idx"][k, :rp[k, -1]]
                           for k in range(rp.shape[0])])
    u, v = w[:, :-1].ravel(), w[:, 1:].ravel()
    assert (np.isin(u * V + v, keys) | ((u == v) & (deg[:, u] == 0).any(0))
            ).all()


# ---- the walk kernels (K6-K9, csrc/walk.cu) ----------------------------

def walk_graph(weighted, seed=0):
    """A 40-node graph with dead ends (vertices 34-39 have no out-edges),
    weights in [0.5, 3) where `weighted`."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, 34, 160), rng.integers(0, 38, 160)
    w = (rng.random(160).astype(np.float32) * 2.5 + 0.5) if weighted \
        else None
    return Graph(src, dst, w, num_nodes=40)


def tail_graph(weighted=True):
    """The triangle with a tail, undirected: 0-1 (weight 3), 1-2 (1), 2-0
    (2), 2-3 (0.5), or every weight 1."""
    w = np.array([3.0, 1.0, 2.0, 0.5], dtype=np.float32) if weighted \
        else None
    return Graph(np.array([0, 1, 2, 2]), np.array([1, 2, 0, 3]), w,
                 directed=False)


def one_layer(g, dev):
    """`g` as Struc2Vec layers of one layer (no layer moves: every
    emission is one weighted step)."""
    accept, alias = g.host_alias()
    return s2v.layers_to(dict(
        row_ptr=g.row_ptr[None], col_idx=g.col_idx[None],
        accept=accept[None], alias=alias[None],
        gamma=np.zeros((1, g.num_nodes), np.float32)), dev)


def walk_runs(kind, g, dev, starts, length, p=0.25, q=4.0, layers=None):
    """(kernel(generator=, draws=), plain(generator=, draws=), draws
    shapes) of one walk kind on g (multilayer: on `layers`, else on g as
    one layer)."""
    dg = g.to(dev)
    B = starts.shape[0]
    if kind in ("uniform", "weighted"):
        if kind == "uniform":
            args = (dg.row_ptr, dg.col_idx, dg.degree, starts)
            return (functools.partial(walk.uniform_walks, *args,
                                      length=length),
                    functools.partial(walk.uniform_walks_plain, *args,
                                      length=length),
                    walk.uniform_draw_shapes(B, length))
        args = (dg.row_ptr, dg.col_idx, dg.degree, *g.alias_tables(dev),
                starts)
        return (functools.partial(walk.weighted_walks, *args, length=length),
                functools.partial(walk.weighted_walks_plain, *args,
                                  length=length),
                walk.weighted_draw_shapes(B, length))
    if kind == "exact":
        nbr, nbr_w = g.neighbor_matrix(dev)
        args = (dg.degree, nbr, nbr_w, starts, p, q)
        return (functools.partial(walk.node2vec_walks, *args, length=length),
                functools.partial(walk.node2vec_walks_plain, *args,
                                  length=length),
                walk.node2vec_draw_shapes(B, length, nbr.shape[1]))
    if kind == "multilayer":
        ly = one_layer(g, dev) if layers is None else layers
        args = (ly["row_ptr"], ly["col_idx"], ly["accept"], ly["alias"],
                ly["gamma"], starts)

        def run(fn):
            return lambda generator=None, draws=None: fn(
                *args, generator, 0.3, length=length, draws=draws)
        return (run(s2v.multilayer_walks), run(s2v.multilayer_walks_plain),
                s2v.multilayer_draw_shapes(B, length))
    form = kind.split("_", 1)[1]
    kw = dict(length=length, max_degree=max(dg.max_degree, 1))
    if form != "bound":
        kw.update(edge_weight=dg.edge_weight, wsum=g.weight_sums(dev))
    if form.startswith("dense"):
        kw.update(nbr=g.neighbor_ids(dev), uniform_rows=form == "dense")
    args = (dg.row_ptr, dg.col_idx, dg.degree, *g.alias_tables(dev), starts,
            p, q)
    return (functools.partial(walk.node2vec_walks_rejection, *args, **kw),
            functools.partial(walk.node2vec_walks_rejection_plain, *args,
                              **kw),
            walk.rejection_draw_shapes(B, length, p, q,
                                       envelope=form != "bound",
                                       row_slots=form == "dense"))


WALK_KINDS = ["uniform", "weighted", "exact", "rejection_csr",
              "rejection_dense", "rejection_dense_alias", "rejection_bound",
              "multilayer"]


def kernel_of(kind):
    return {"uniform": walk.uniform_walks, "weighted": walk.weighted_walks,
            "exact": walk.node2vec_walks,
            "multilayer": s2v.multilayer_walks}.get(
                kind, walk.node2vec_walks_rejection)


@pytest.mark.parametrize("kind", WALK_KINDS)
def test_walk_kernel_equals_plain_on_shared_draws(cuda, kind):
    """Each walk kernel, one launch, walks its plain version's corpus on
    the same uniforms (dead ends included); from a seed it walks the same
    corpus twice, every hop an edge."""
    layers = None
    if kind == "multilayer":
        g = load_dataset("flight-brazil").graph
        layers = s2v.layers_to(s2v.build_layer_csr(
            s2v.build_context_graph(g)[0], g.num_nodes), cuda)
    else:
        g = walk_graph(kind in ("weighted", "exact", "rejection_csr",
                                "rejection_dense_alias"))
    starts = torch.arange(g.num_nodes, device=cuda).repeat(5)
    kernel, plain, shapes = walk_runs(kind, g, cuda, starts, 8,
                                      layers=layers)
    draws = walk.record_draws(
        shapes, torch.Generator(device=cuda).manual_seed(1))
    k = kernel_of(kind)
    before = k.launches
    got = kernel(draws=draws)
    assert k.launches == before + 1
    assert torch.equal(got, plain(draws=draws))
    a = kernel(generator=torch.Generator(device=cuda).manual_seed(2))
    b = kernel(generator=torch.Generator(device=cuda).manual_seed(2))
    assert torch.equal(a, b)
    if kind != "multilayer":
        w = a.cpu().numpy().astype(np.int64)
        src, dst, _ = g.edges()
        u, v = w[:, :-1].ravel(), w[:, 1:].ravel()
        hop = v >= 0
        assert np.isin(u[hop] * 40 + v[hop], src * 40 + dst).all()
        # once dead, dead for good
        assert ((w[:, 1:] >= 0) <= (w[:, :-1] >= 0)).all()


@pytest.mark.parametrize("kind", WALK_KINDS)
def test_walk_kernel_third_hop_law(cuda, kind):
    """The third hop from 0 through 1 on the weighted triangle with a tail,
    from Philox draws: from 1, having come from 0, N(1) = {0 (w 3), 2 (w
    1)}, 2 in N(0), so (p,q) = (0.25, 4) weighs 0 by 1/p; the uniform walk
    ignores the weights; the one-layer multilayer walk is the weighted
    walk; dense rejection's uniform row slots take the unweighted graph
    (the only one simulate_walks gives them), where 0 weighs 1/p and 2
    weighs 1."""
    g = tail_graph(weighted=kind != "rejection_dense")
    starts = torch.zeros(40000, dtype=torch.int64, device=cuda)
    kernel, _, _ = walk_runs(kind, g, cuda, starts, 3)
    walks = kernel(
        generator=torch.Generator(device=cuda).manual_seed(4)).cpu().numpy()
    sel = walks[walks[:, 1] == 1]
    assert len(sel) > 2000
    target = {"uniform": [1.0, 1.0], "weighted": [3.0, 1.0],
              "multilayer": [3.0, 1.0]}.get(kind, [3.0 / 0.25, 1.0])
    if kind == "rejection_dense":
        target = [1.0 / 0.25, 1.0]
    freq = np.bincount(sel[:, 2], minlength=4)[[0, 2]] / len(sel)
    np.testing.assert_allclose(freq, np.array(target) / sum(target),
                               atol=0.03)


@pytest.mark.parametrize("kind", ["uniform", "weighted", "exact",
                                  "rejection_csr", "rejection_dense",
                                  "rejection_bound"])
def test_walk_kernel_dead_end_row(cuda, kind):
    """0 -> 1 -> 2 -> 3, nothing out of 3: -1 from the dead end on."""
    g = Graph(np.array([0, 1, 2]), np.array([1, 2, 3]), num_nodes=4)
    starts = torch.tensor([0, 3, 2], device=cuda)
    kernel, _, _ = walk_runs(kind, g, cuda, starts, 6)
    walks = kernel(generator=torch.Generator(device=cuda).manual_seed(0))
    assert walks.cpu().tolist() == [[0, 1, 2, 3, -1, -1],
                                    [3, -1, -1, -1, -1, -1],
                                    [2, 3, -1, -1, -1, -1]]


def test_walk_kernels_refuse_wrong_inputs(cuda):
    g = walk_graph(True)
    dg = g.to(cuda)
    nbr, nbr_w = g.neighbor_matrix(cuda)
    accept, alias = g.alias_tables(cuda)
    starts = torch.arange(40, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    with pytest.raises(ValueError, match="col_idx"):
        walk.uniform_walks(dg.row_ptr, dg.col_idx.long(), dg.degree, starts,
                           length=4, generator=gen)
    with pytest.raises(ValueError, match="accept"):
        walk.weighted_walks(dg.row_ptr, dg.col_idx, dg.degree,
                            accept.double(), alias, starts, length=4,
                            generator=gen)
    with pytest.raises(ValueError, match="nbr_w"):
        walk.node2vec_walks(dg.degree, nbr, nbr_w.double(), starts, 0.25,
                            4.0, length=4, generator=gen)
    with pytest.raises(ValueError, match="degree"):
        walk.node2vec_walks_rejection(
            dg.row_ptr, dg.col_idx, dg.degree.long(), accept, alias, starts,
            0.25, 4.0, length=4, max_degree=dg.max_degree, generator=gen)
    with pytest.raises(ValueError, match="several devices"):
        walk.uniform_walks(dg.row_ptr, dg.col_idx, dg.degree, starts.cpu(),
                           length=4, generator=gen)
    with pytest.raises(ValueError, match="draws"):
        walk.uniform_walks(dg.row_ptr, dg.col_idx, dg.degree, starts,
                           length=4, draws=torch.rand(5, device=cuda))
    ly = one_layer(tail_graph(), cuda)
    with pytest.raises(ValueError, match="accept"):
        s2v.multilayer_walks(ly["row_ptr"], ly["col_idx"],
                             ly["accept"].double(), ly["alias"], ly["gamma"],
                             torch.zeros(3, device=cuda, dtype=torch.int32),
                             gen, 0.3, length=4)


def assert_updates_close(got, want, init):
    """Each tensor's update got - init within 1e-3 of want - init in L2
    norm."""
    for a, b, p0 in zip(got, want, init):
        assert float((a - b).norm()) <= 1e-3 * float((b - p0).norm())


def sdne_steps(mode, device):
    """Three steps of one SDNE trainer on a 600-node graph; the initial
    parameters and the permutation are drawn on the CPU, so every device
    starts from the same ones. Returns (initial parameters, parameters,
    losses) on the CPU."""
    g = synthetic_wiki(num_nodes=600, num_classes=6, seed=5).graph
    m = SDNE(g, hidden_size=[64, 32], device=device)
    init = [p.detach().cpu().clone() for p in m.net.parameters()]
    if mode == "full":
        m.train(batch_size=1024, epochs=3)
    elif mode == "minibatch":
        m.train(batch_size=256, epochs=1)  # ceil(600 / 256) = 3 steps
    else:
        m.train_sparse(epochs=3, row_chunk=256)
        assert m._A is None and m._L is None
    return (init, [p.detach().cpu() for p in m.net.parameters()],
            m.losses.cpu())


@pytest.mark.parametrize("mode", ["full", "minibatch", "sparse"])
def test_sdne_steps_on_card_match_cpu(cuda, mode):
    init, want, want_loss = sdne_steps(mode, "cpu")
    init_c, got, loss = sdne_steps(mode, cuda)
    _, again, loss_again = sdne_steps(mode, cuda)
    assert loss.shape == (3,)
    for a, b in zip(got + [loss], again + [loss_again]):
        assert torch.equal(a, b)
    for a, b in zip(init, init_c):
        assert torch.equal(a, b)
    np.testing.assert_allclose(loss.numpy(), want_loss.numpy(), rtol=1e-5)
    assert_updates_close(got, want, init)


@pytest.mark.parametrize("tied", [False, True])
def test_dense_fit_on_card_matches_cpu(cuda, tied):
    """The co-occurrence of a Wiki-sized corpus equals the CPU's bit for
    bit; five dense_fit steps are bit-identical from run to run, and their
    loss (rtol=1e-5) and updates (1e-3 in L2 norm) agree with the CPU's."""
    V = 2405
    gen = torch.Generator().manual_seed(9)
    walks = torch.randint(0, V, (19240, 10), generator=gen,
                          dtype=torch.int32)
    walks[::7, 6:] = -1
    C = dense.cooccurrence(walks, V, 5)
    C_card = dense.cooccurrence(walks.to(cuda), V, 5)
    assert torch.equal(C_card.cpu(), C)
    U0 = dense.initial_table(V, 128, 4, "cpu")

    def fit(C, U0):
        return dense.dense_fit(C, U0, 5, 0.75, 0.1, 0.9, 0.99, 1e-8,
                               steps=5, tied=tied)

    want = fit(C, U0)
    got = [t.cpu() for t in fit(C_card, U0.to(cuda))]
    again = [t.cpu() for t in fit(C_card, U0.to(cuda))]
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    np.testing.assert_allclose(got[2].numpy(), want[2].numpy(), rtol=1e-5)
    if tied:
        assert not got[1].any()
    assert_updates_close(got[:1 if tied else 2], want[:2],
                         [U0, torch.zeros_like(U0)])


def test_line_dense_inputs_on_card(cuda):
    g = load_dataset("wiki").graph
    (A, q), (A_cpu, q_cpu) = (line.dense_line_inputs(g, cuda),
                              line.dense_line_inputs(g, "cpu"))
    assert torch.equal(A.cpu(), A_cpu)
    assert torch.equal(q, line.dense_line_inputs(g, cuda)[1])
    np.testing.assert_allclose(q.cpu().numpy(), q_cpu.numpy(), rtol=1e-6)


class Interrupt(Exception):
    pass


class StopAt:
    """A metrics logger that raises on its n-th line."""

    def __init__(self, n):
        self.n, self.lines = n, 0

    def log(self, **fields):
        self.lines += 1
        if self.lines == self.n:
            raise Interrupt


@pytest.mark.parametrize("hs", [0, 1])
def test_resume_bit_identical_on_card(cuda, tmp_path, hs):
    """DeepWalk (SGNS: K1-K3; hs=1: K10, K4) interrupted after chunk 2 of 3
    (a checkpoint every chunk), then resumed in a fresh model: the tables
    of an uninterrupted train, bit for bit, with the kernels launched for
    the two chunks that remained."""
    from graphembedding_tpu_torch import DeepWalk

    g = synthetic_wiki(num_nodes=300, num_classes=4, seed=2).graph
    kw = dict(embed_size=32, window_size=3, iter=3, hs=hs)
    want = DeepWalk(g, walk_length=10, num_walks=10, device=cuda)
    want.train(**kw)
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=1)
    m = DeepWalk(g, walk_length=10, num_walks=10, device=cuda)
    with pytest.raises(Interrupt):
        m.train(metrics=StopAt(2), **kw, **ck)
    m = DeepWalk(g, walk_length=10, num_walks=10, device=cuda)
    kernels = ((hs_block_grads, scatter_add_small) if hs else
               (sgns_block_grads, scatter_add_rows, gather_rows))
    before = [k.launches for k in kernels]
    m.train(**kw, **ck)
    torch.cuda.synchronize()
    steps = m.losses.shape[0]
    assert steps == 2 * want.losses.shape[0] // 3
    per_step = (1, 2) if hs else (1, 2, 2)
    assert [k.launches - b for k, b in zip(kernels, before)] == [
        n * steps for n in per_step]
    assert torch.equal(m.w_in, want.w_in)
    assert torch.equal(m.w_out, want.w_out)


def test_line_resume_bit_identical_on_card(cuda, tmp_path, monkeypatch):
    """LINE order 'all' (K3, K4) interrupted inside order 'second', then
    resumed: the tables of an uninterrupted train, bit for bit."""
    g = synthetic_wiki(num_nodes=300, num_classes=4, seed=2).graph
    # 3 chunks of 512 steps of 256 edges an order
    kw = dict(batch_size=256,
              epochs=3 * line.CHUNK_STEPS * 256 / g.num_edges)
    want = LINE(g, embedding_size=32, order="all", device=cuda)
    want.train(**kw)
    chunk, calls = line.line_train_chunk, []

    def interrupted(*a, **k):
        calls.append(1)
        if len(calls) == 5:
            raise Interrupt
        return chunk(*a, **k)

    monkeypatch.setattr(line, "line_train_chunk", interrupted)
    with pytest.raises(Interrupt):
        LINE(g, embedding_size=32, order="all", device=cuda).train(
            checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    monkeypatch.setattr(line, "line_train_chunk", chunk)
    m = LINE(g, embedding_size=32, order="all", device=cuda)
    m.train(checkpoint_dir=str(tmp_path), checkpoint_every=1, **kw)
    assert m.losses.shape[0] == 2 * line.CHUNK_STEPS
    assert torch.equal(m.embedding_table, want.embedding_table)
    assert torch.equal(m.context_emb, want.context_emb)


def test_most_similar_on_card_matches_numpy(cuda, monkeypatch):
    """most_similar at 300,000 rows on the card (one product and top-k)
    against the numpy path on the same table: the same names apart from
    ties, scores within 1e-5."""
    from graphembedding_tpu_torch.utils import simquery

    rng = np.random.default_rng(4)
    table = rng.standard_normal((300_000, 32)).astype(np.float32)
    names = [str(i) for i in range(table.shape[0])]
    queries = [dict(node="7"), dict(vector=table[11] + 0.5)]
    got = [simquery.most_similar((names, table), topn=10, **q)
           for q in queries]
    monkeypatch.setattr(simquery, "_DEVICE_MIN_ROWS", 10 ** 9)
    want = [simquery.most_similar((names, table), topn=10, **q)
            for q in queries]
    for g, w in zip(got, want):
        np.testing.assert_allclose([s for _, s in g], [s for _, s in w],
                                   atol=1e-5)
        tied = {n for n, s in w if abs(s - w[-1][1]) <= 1e-5}
        assert {n for n, _ in g} ^ {n for n, _ in w} <= tied | {
            n for n, s in g if abs(s - w[-1][1]) <= 1e-5}


# ---- a chunk of steps as one CUDA graph (train/chunk_graph.py) --------

def wiki_walks(cuda, seed=1):
    ds = load_dataset("wiki")
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return ds.graph.num_nodes, simulate_walks(ds.graph, 80, 10, generator=gen)


def sgns_chunks(cuda, sparse_cap=False):
    """DeepWalk on Wiki's step (Bw = 4032: 47 blocks), two chunks of 4
    steps, the second over blocks 45, 46, 0, 1; the cap dense or
    sparse."""
    V, walks = wiki_walks(cuda)
    D, K, W = 128, 64, 5
    geo = sg.block_geometry(walks.shape[0], 10, 4032, 4)
    gen = torch.Generator(device=cuda).manual_seed(2)
    w0 = torch.cat([(torch.rand((V, D), generator=gen, device=cuda) - 0.5)
                    / D, torch.randn((V, D), generator=gen, device=cuda)
                    * 0.05], 1)
    draws = [(t0, sg.window_draws(gen, (4, geo.G, geo.PL), W),
              torch.randint(0, V, (4, geo.G2, K), generator=gen,
                            device=cuda, dtype=torch.int32))
             for t0 in (0, geo.n_blocks - 2)]

    def run():
        w, out = w0.clone(), []
        for t0, eff, negs in draws:
            _, losses, pairs = sg.sgns_block_chunk_cat(
                w, walks, eff, negs, 0.025, 1e-4, t0, 192.0, block_walks=4032,
                window=W, negative=5, neg_share_packs=4,
                sparse_cap=sparse_cap)
            out += [losses, pairs]
        return [w, *out]
    return run


def hs_chunks(cuda, tree, sparse_cap=False):
    """DeepWalk hs=1 on Wiki's step (Bw = 504: 381 blocks; the Huffman tree
    of the corpus, [2404, 128]) or a 130-row tree (Struc2Vec's on
    flight-brazil: 131 nodes, 10,480 walks of 10, 20 blocks): two chunks of
    4 steps, the second wrapping around the blocks; the cap dense or
    sparse."""
    if tree == "wiki":
        V, walks = wiki_walks(cuda)
    else:
        V = 131
        rng = np.random.default_rng(3)
        walks = torch.as_tensor(
            np.minimum(rng.zipf(1.6, (80 * V, 10)) - 1, V - 1).astype(
                np.int32), device=cuda)
    D, W = 128, 5
    points, codes, _ = hs.build_huffman(sg.corpus_counts(walks, V))
    points = torch.as_tensor(points, device=cuda)
    codes = torch.as_tensor(codes, device=cuda)
    geo = sg.block_geometry(walks.shape[0], 10, 504, 1)
    gen = torch.Generator(device=cuda).manual_seed(4)
    w_in0 = (torch.rand((V, D), generator=gen, device=cuda) - 0.5) / D
    w_tree0 = torch.randn((V - 1, D), generator=gen, device=cuda) * 0.05
    draws = [(t0, sg.window_draws(gen, (4, geo.G, geo.PL), W))
             for t0 in (0, geo.n_blocks - 2)]

    def run():
        w_in, w_tree, out = w_in0.clone(), w_tree0.clone(), []
        for t0, eff in draws:
            *_, losses, pairs = hs.hs_block_chunk(
                w_in, w_tree, walks, points, codes, eff, 0.025, 1e-4, t0,
                1152.0, block_walks=504, window=W, sparse_cap=sparse_cap)
            out += [losses, pairs]
        return [w_in, w_tree, *out]
    return run


def line_chunks(cuda, order):
    """LINE on Wiki's step (B = 1024, K = 5): two chunks of 8 steps."""
    ds = load_dataset("wiki")
    m = LINE(ds.graph, embedding_size=128, order=order, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(6)
    draws = [line.line_bulk_samples(
        m._edge_src, m._edge_dst, m._edge_accept, m._edge_alias,
        m._neg_table, gen, 0.025, t0, 796.0, chunk_steps=8, batch_size=1024,
        negative=5, k_shared=0) for t0 in (0, 8)]
    emb0, ctx0 = ((m.first_emb, None) if order == "first"
                  else (m.second_emb, m.context_emb))

    def run():
        emb = emb0.clone()
        ctx = None if ctx0 is None else ctx0.clone()
        out = []
        for d in draws:
            out.append(line.line_steps(emb, ctx, *d, negative=5)[2])
        return [emb, *out] + ([] if ctx is None else [ctx])
    return run


@pytest.mark.parametrize("kind", ["sgns", "sgns sparse", "hs wiki",
                                  "hs wiki sparse", "hs tree", "line second",
                                  "line first"])
def test_chunk_graph_equals_the_loop_on_card(cuda, kind, monkeypatch):
    """Two chunks replayed from one captured CUDA graph torch.equal to the
    same chunks launched one by one (the card taken out of
    `chunk_graph.CAPTURES`; tables, losses, pairs), the second chunk
    wrapping around the corpus' blocks, with the same launches of each
    kernel (K2's and K4's cooperative launches and K1's cluster launch as
    graph nodes)."""
    from graphembedding_tpu_torch.train import chunk_graph

    run = {"sgns": lambda: sgns_chunks(cuda),
           "sgns sparse": lambda: sgns_chunks(cuda, sparse_cap=True),
           "hs wiki": lambda: hs_chunks(cuda, "wiki"),
           "hs wiki sparse": lambda: hs_chunks(cuda, "wiki", sparse_cap=True),
           "hs tree": lambda: hs_chunks(cuda, "tree"),
           "line second": lambda: line_chunks(cuda, "second"),
           "line first": lambda: line_chunks(cuda, "first")}[kind]()
    kernels = (sgns_block_grads, gather_rows, scatter_add_rows,
               scatter_add_small, hs_block_grads)
    chunk_graph.release()
    got = {}
    for graphs in (False, True, True):  # the loop; a capture; replays only
        with monkeypatch.context() as m:
            if not graphs:
                m.delitem(chunk_graph.CAPTURES, "cuda")
            before = [k.launches for k in kernels]
            out = run()
            torch.cuda.synchronize()
        got.setdefault(graphs, []).append(
            (out, [k.launches - b for k, b in zip(kernels, before)]))
    assert len(chunk_graph.held(cuda)) == 1
    (loop, loop_n), = got[False]
    for out, n in got[True]:
        assert n == loop_n and sum(n) > 0
        assert all(torch.equal(a, b) for a, b in zip(out, loop))
    assert all(bool(torch.isfinite(t).all()) for t in loop)
    assert any(t.dim() == 1 and bool((t > 0).all()) for t in loop)  # losses


# ---- the mesh trainers' chunks at world 1 over NCCL as CUDA graphs -----

MESH_KINDS = ("rowshard", "rowshard prefetch", "dp", "hs", "line",
              "sdne full", "sdne sparse")


def mesh_chunks(dev, kind, mesh):
    """run() for two chunks of a mesh trainer at the Wiki shapes on a
    (1, 1) mesh: the rowshard and dp SGNS chunks (Bw = 4032) and the HS dp
    chunk (Bw = 504) of 4 steps each, the second wrapping around the
    corpus' blocks; the LINE dp chunk of 8 steps (B = 1024, order
    'second'); SDNE [256, 128] over the mesh, 4 epochs in two chunks of a
    checkpoint each. run() returns the tables, losses and pairs."""
    import tempfile

    from graphembedding_tpu_torch.parallel import hsoftmax as phs
    from graphembedding_tpu_torch.parallel import line as pline
    from graphembedding_tpu_torch.parallel import rowshard, sgns

    if kind.startswith("sdne"):
        g = load_dataset("wiki").graph
        train = (lambda m, **k: m.train(batch_size=3000, epochs=4,
                                        mesh=mesh, **k)) \
            if kind == "sdne full" else (lambda m, **k: m.train_sparse(
                epochs=4, row_chunk=512, mesh=mesh, **k))

        def run():
            m = SDNE(g, hidden_size=[256, 128], device=dev)
            with tempfile.TemporaryDirectory() as d:
                train(m, checkpoint_dir=d, checkpoint_every=2)
            return [p.detach().clone() for p in m.net.parameters()] + [
                m.losses]
        return run
    if kind == "line":
        ds = load_dataset("wiki")
        m = LINE(ds.graph, embedding_size=128, order="second", device=dev)
        gen = torch.Generator(device=dev).manual_seed(6)
        draws = [line.line_bulk_samples(
            m._edge_src, m._edge_dst, m._edge_accept, m._edge_alias,
            m._neg_table, gen, 0.025, t0, 796.0, chunk_steps=8,
            batch_size=1024, negative=5, k_shared=0) for t0 in (0, 8)]

        def run():
            emb, ctx = m.second_emb.clone(), m.context_emb.clone()
            losses = [pline.sharded_line_chunk(emb, ctx, *d, mesh=mesh,
                                               negative=5)[2] for d in draws]
            return [emb, ctx, *losses]
        return run
    V, walks = wiki_walks(dev)
    NW = walks.shape[0]
    gen = torch.Generator(device=dev).manual_seed(2)
    if kind == "hs":
        points, codes, _ = hs.build_huffman(sg.corpus_counts(walks, V))
        points = torch.as_tensor(points, device=dev)
        codes = torch.as_tensor(codes, device=dev)
        geo = sgns.dp_geometry(NW, 10, 504, 1, 1)
        w_in0 = (torch.rand((V, 128), generator=gen, device=dev) - 0.5) / 128
        w_tree0 = torch.randn((V - 1, 128), generator=gen, device=dev) * 0.05
        draws = [(t0, sg.window_draws(gen, (4, geo.G, geo.PL), 5))
                 for t0 in (0, geo.n_blocks - 2)]

        def run():
            w_in, w_tree, out = w_in0.clone(), w_tree0.clone(), []
            for t0, eff in draws:
                out += phs.sharded_hs_chunk(
                    w_in, w_tree, walks, points, codes, eff, 0.025, 1e-4,
                    t0, 1152.0, mesh=mesh, block_walks=504, window=5)[2:]
            return [w_in, w_tree, *out]
        return run
    geo = (rowshard.rank_geometry if kind.startswith("rowshard")
           else sgns.dp_geometry)(NW, 10, 4032, 1, 4)
    w0 = torch.cat([(torch.rand((V, 128), generator=gen, device=dev) - 0.5)
                    / 128, torch.randn((V, 128), generator=gen, device=dev)
                    * 0.05], 1)
    draws = [(t0, sg.window_draws(gen, (4, geo.G, geo.PL), 5),
              torch.randint(0, V, (4, geo.G2, 64), generator=gen, device=dev,
                            dtype=torch.int32))
             for t0 in (0, geo.n_blocks - 2)]
    kw = dict(mesh=mesh, block_walks=4032, window=5, negative=5,
              neg_share_packs=4)
    if kind == "dp":
        chunk = functools.partial(sgns.sharded_sgns_chunk, sync_every=2,
                                  **kw)
    else:
        chunk = functools.partial(rowshard.rowsharded_sgns_chunk,
                                  prefetch=kind == "rowshard prefetch", **kw)

    def run():
        w, out = w0.clone(), []
        for t0, eff, negs in draws:
            out += chunk(w, walks, eff, negs, 0.025, 1e-4, t0, 192.0)[1:]
        return [w, *out]
    return run


def mesh_chunks_world1_rank(info):
    """In a spawned NCCL rank of world size 1: each kind of `mesh_chunks`
    launched one by one (the card out of `chunk_graph.CAPTURES`), then
    through a capture and through replays alone; for each kind whether the
    graphs' outputs equal the loop's, the launches of each way, the graphs
    held and whether the loop's outputs are finite."""
    from graphembedding_tpu_torch.parallel import make_mesh
    from graphembedding_tpu_torch.train import chunk_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = info.device
    mesh = make_mesh((1, 1), device=dev)
    out = {}
    for kind in MESH_KINDS:
        run = mesh_chunks(dev, kind, mesh)
        chunk_graph.release()
        got = {}
        for graphs in (False, True, True):  # the loop; a capture; replays
            cuda = None if graphs else chunk_graph.CAPTURES.pop("cuda")
            try:
                before = [k.launches for k in chunk_graph.COUNTERS]
                res = run()
                torch.cuda.synchronize()
            finally:
                if cuda is not None:
                    chunk_graph.CAPTURES["cuda"] = cuda
            got.setdefault(graphs, []).append(
                (res, [k.launches - b for k, b in
                       zip(chunk_graph.COUNTERS, before)]))
        (loop, loop_n), = got[False]
        out[kind] = dict(
            held=len(chunk_graph.held(dev)), loop_n=loop_n,
            graph_n=[n for _, n in got[True]],
            equal=[all(torch.equal(a, b) for a, b in zip(res, loop))
                   for res, _ in got[True]],
            finite=all(bool(torch.isfinite(t).all()) for t in loop))
        chunk_graph.release()
    return out


@pytest.fixture(scope="module")
def mesh_world1():
    """`mesh_chunks_world1_rank`'s results, or skip where there is no
    card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (NCCL and the kernels)")
    from graphembedding_tpu_torch.parallel.launch import run_ranks

    [out] = run_ranks(mesh_chunks_world1_rank, 1, backend="nccl",
                      device="cuda:0", timeout_s=600)
    return out


@pytest.mark.parametrize("kind", MESH_KINDS)
def test_mesh_chunk_graph_equals_the_loop_on_card(mesh_world1, kind):
    """At world 1 over NCCL, two chunks of each mesh trainer through one
    captured CUDA graph (a capture, then replays alone) torch.equal to the
    same chunks launched one by one: tables, losses, pairs; K1-K4 (none
    for SDNE) launched as many times each way."""
    got = mesh_world1[kind]
    assert got["held"] == 1 and got["finite"], got
    assert got["equal"] == [True, True], got
    assert got["graph_n"] == [got["loop_n"]] * 2, got
    assert (sum(got["loop_n"]) == 0) == kind.startswith("sdne"), got


def fresh_mesh_dp_rank(info):
    """In a spawned NCCL rank of world size 1: the dp chunks of
    `mesh_chunks` as the first collectives on a new mesh's groups, through
    a capture (the warm-up step does not sync: the first exchange on the
    data group would fall inside the capture), then through the loop;
    (outputs equal, graphs held)."""
    from graphembedding_tpu_torch.parallel import make_mesh
    from graphembedding_tpu_torch.train import chunk_graph

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = info.device
    run = mesh_chunks(dev, "dp", make_mesh((1, 1), device=dev))
    graphs = run()
    torch.cuda.synchronize()
    held = len(chunk_graph.held(dev))
    cuda = chunk_graph.CAPTURES.pop("cuda")
    try:
        loop = run()
        torch.cuda.synchronize()
    finally:
        chunk_graph.CAPTURES["cuda"] = cuda
    return all(torch.equal(a, b) for a, b in zip(graphs, loop)), held


def test_dp_chunk_captures_on_a_fresh_mesh(cuda):
    """`chunk_graph.join_groups`: a capture whose groups have not
    exchanged yet (NCCL makes a communicator at its first collective,
    which a capture refuses) captures and equals the loop."""
    from graphembedding_tpu_torch.parallel.launch import run_ranks

    [(equal, held)] = run_ranks(fresh_mesh_dp_rank, 1, backend="nccl",
                                device="cuda:0", timeout_s=300)
    assert equal and held == 1


def sdne_chunks(cuda, mode):
    """SDNE [256, 128] on Wiki: 4 epochs (the minibatch loop: 2 epochs of
    3 steps), in two chunks of a checkpoint each."""
    import tempfile

    g = load_dataset("wiki").graph
    train = {"sdne full": lambda m, **k: m.train(batch_size=3000, epochs=4,
                                                 **k),
             "sdne minibatch": lambda m, **k: m.train(batch_size=1024,
                                                      epochs=2, **k),
             "sdne sparse": lambda m, **k: m.train_sparse(
                 epochs=4, row_chunk=512, **k)}[mode]

    def run():
        m = SDNE(g, hidden_size=[256, 128], device=cuda)
        with tempfile.TemporaryDirectory() as d:
            train(m, checkpoint_dir=d, checkpoint_every=2 if mode !=
                  "sdne minibatch" else 1)
        return [p.detach().clone() for p in m.net.parameters()] + [m.losses]
    return run


def dense_chunks(cuda, tied):
    """dense_fit on a Wiki-sized corpus' co-occurrence: 8 steps."""
    V = 2405
    gen = torch.Generator().manual_seed(9)
    walks = torch.randint(0, V, (19240, 10), generator=gen,
                          dtype=torch.int32)
    C = dense.cooccurrence(walks.to(cuda), V, 5)
    U0 = dense.initial_table(V, 128, 4, cuda)

    def run():
        return list(dense.dense_fit(C, U0, 5, 0.75, 0.1, 0.9, 0.99, 1e-8,
                                    steps=8, tied=tied))
    return run


@pytest.mark.parametrize("kind", ["sdne full", "sdne minibatch",
                                  "sdne sparse", "dense", "dense tied"])
def test_sdne_and_dense_chunk_graph_equals_the_loop_on_card(cuda, kind,
                                                            monkeypatch):
    """SDNE's three trainers (each in two chunks) and dense_fit (one chunk
    of all its steps) through the captured CUDA graphs torch.equal to the
    same steps launched one by one (the card taken out of
    `chunk_graph.CAPTURES`), on a capture and on replays alone; no kernel
    of the port launched."""
    from graphembedding_tpu_torch.train import chunk_graph

    run = (sdne_chunks(cuda, kind) if kind.startswith("sdne")
           else dense_chunks(cuda, kind == "dense tied"))
    chunk_graph.release()
    counts = [k.launches for k in chunk_graph.COUNTERS]
    got = {}
    for graphs in (False, True, True):  # the loop; a capture; replays only
        with monkeypatch.context() as m:
            if not graphs:
                m.delitem(chunk_graph.CAPTURES, "cuda")
            out = run()
            torch.cuda.synchronize()
        got.setdefault(graphs, []).append(out)
    assert len(chunk_graph.held(cuda)) == 1
    assert [k.launches for k in chunk_graph.COUNTERS] == counts
    loop, = got[False]
    for out in got[True]:
        assert all(torch.equal(a, b) for a, b in zip(out, loop))
    assert all(bool(torch.isfinite(t).all()) for t in loop)
    chunk_graph.release()


def drawing_step(b, s, ops, *, gen):
    """A step that draws (from `gen`, or from the card's default generator
    for None) through the kernels (ops "kernels"), not in its warm-up."""
    if ops == "kernels":
        b["t"].add_(torch.rand(b["t"].shape, device=b["t"].device,
                               generator=gen))
    return (b["t"].sum(),)


def erring_step(b, s, ops):
    """A step whose kernel launch returns an error (K4's group plan with
    no scratch) through the kernels."""
    from graphembedding_tpu_torch.kernels import build as kb

    t = b["t"]
    if ops == "kernels":
        ids = torch.zeros(4, dtype=torch.int32, device=t.device)
        grads = torch.ones((4, t.shape[1]), device=t.device)
        kb.check(kb.library().ge_scatter_add_small(
            t.device.index, t.data_ptr(), t.stride(0), t.shape[0],
            ids.data_ptr(), grads.data_ptr(), 4, t.shape[1], None, 1,
            kb.stream_ptr(t.device)), "scatter_add_small")
    return (t.sum(),)


def syncing_step(b, s, ops):
    """A step that reads a value back to the host through the kernels (as
    the plain scatter's boolean index does)."""
    if ops == "kernels":
        b["t"].mul_(float(b["t"].sum()))
    return (b["t"].sum(),)


def test_failed_chunk_capture_raises_on_card(cuda):
    """A chunk whose step draws from a generator, whose kernel launch
    returns an error, or that makes a host round trip raises; the caller's
    table is untouched (no loop ran on it), no graph is kept and no launch
    is counted; the card's default generator draws on after it where it
    stood before, and the card trains on."""
    from graphembedding_tpu_torch.train import chunk_graph

    chunk_graph.release()
    table = torch.randn((8, 4), device=cuda)
    want = table.clone()
    counts = [k.launches for k in chunk_graph.COUNTERS]
    gen = torch.Generator(device=cuda).manual_seed(1)
    default = torch.cuda.default_generators[torch.cuda.current_device()]
    rng = default.get_state()
    for step, consts, match in ((drawing_step, {"gen": gen}, None),
                                (drawing_step, {"gen": None},
                                 "default generator"),
                                (erring_step, {}, "scatter_add_small"),
                                (syncing_step, {}, None)):
        with pytest.raises(RuntimeError, match=match):
            chunk_graph.run_chunk(step, 3, {"t": table}, {}, ops="kernels",
                                  plain=None, consts=consts)
        torch.cuda.synchronize()
        assert torch.equal(table, want)
    assert not chunk_graph.held()
    assert [k.launches for k in chunk_graph.COUNTERS] == counts
    after = torch.rand(16, device=cuda)
    default.set_state(rng)
    assert torch.equal(after, torch.rand(16, device=cuda))
    # a chunk through the kernels after the failures
    V, L = 50, 10
    walks = torch.randint(0, V, (504, L), device=cuda, dtype=torch.int32)
    points, codes, _ = hs.build_huffman(sg.corpus_counts(walks, V))
    w_in, w_tree = torch.randn((V, 8), device=cuda), torch.zeros(
        (V - 1, 8), device=cuda)
    geo = sg.block_geometry(504, L, 504, 1)
    hs.hs_block_chunk(
        w_in, w_tree, walks, torch.as_tensor(points, device=cuda),
        torch.as_tensor(codes, device=cuda),
        torch.full((2, geo.G, geo.PL), 2, dtype=torch.int32, device=cuda),
        0.025, 1e-4, 0, 2.0, block_walks=504, window=2)
    torch.cuda.synchronize()
    assert w_tree.any() and len(chunk_graph.held()) == 1
