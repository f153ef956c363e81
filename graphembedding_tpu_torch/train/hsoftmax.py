"""Hierarchical-softmax skip-gram (the reference's hs=1 trainer) in PyTorch.

Counterpart of `graphembedding_tpu/train/hsoftmax.py` (the block trainer
with the dense update cap, one step at a time). The objective is gensim's
`Word2Vec(sg=1, hs=1)`:

    loss(center c, context m) = sum over t in path(m) of
        -log sigmoid((1 - code_t) ? <u_c, w_t> : -<u_c, w_t>)

over a Huffman tree built from the corpus counts (`build_huffman`): label
= 1 - code, and g = (label - sigmoid) * x on the input row and on every
inner-node row of the path.

A step packs its block of walks as the SGNS step does (G groups of PL =
P * L positions), gathers the centers' rows of `w_in` and the context
paths' rows of `w_tree` (K3), scores every (center, context, tree level)
with three batched products over the flattened n = m * T + t axis, and
scatter-adds both gradients with the per-row update cap (K4 or K2 by
`ops.rows.scatter_add_table`). The products run in full float32, as the
JAX package's einsums ask: `hs_block_chunk` sets torch's float32 matmul
precision to "highest" (no TF32) while it runs.

The window draws of a chunk (`eff`) are an input of `hs_block_chunk`, so a
test can hand it the JAX package's draws; `HSTrainer.fit` makes them with
a `torch.Generator`.

Not ported: the sparse cap form (the dense form computes the same update
at any V), `mesh=`/`sync_every=`, checkpoints and metrics logging.
"""

from __future__ import annotations

import contextlib
import heapq

import numpy as np
import torch
import torch.nn.functional as F

from graphembedding_tpu_torch.ops.rows import ROW_KERNELS, ROW_PLAIN
from graphembedding_tpu_torch.train.skipgram import (
    block_geometry,
    corpus_counts,
    fit_block_walks,
    keep_per_token,
    prepare_epoch,
    window_geometry,
)


def build_huffman(counts: np.ndarray):
    """Huffman tree over node frequencies -> (points, codes, depth).

    points[v, t]: inner-node ids (0..V-2) on the path root -> leaf v, -1
    padded; codes[v, t]: 0/1 branch codes aligned with points. The heap
    holds (count, id) entries, so equal counts break on the node id, as
    word2vec's `create_binary_tree` does; a zero count weighs 1e-9.
    """
    V = counts.shape[0]
    if V == 1:
        return (np.full((1, 1), -1, np.int32),
                np.zeros((1, 1), np.float32), 1)
    heap = [(float(max(c, 1e-9)), i, None, None) for i, c in
            enumerate(counts)]
    heapq.heapify(heap)
    next_inner = 0
    nodes = {}
    while len(heap) > 1:
        a = heapq.heappop(heap)
        b = heapq.heappop(heap)
        nid = V + next_inner
        next_inner += 1
        nodes[nid] = (a[1], b[1])
        heapq.heappush(heap, (a[0] + b[0], nid, a[1], b[1]))

    # walk the tree from the root, collecting each leaf's path
    points = [[] for _ in range(V)]
    codes = [[] for _ in range(V)]
    stack = [(heap[0][1], [], [])]
    while stack:
        nid, pth, cds = stack.pop()
        if nid < V:
            points[nid] = pth
            codes[nid] = cds
            continue
        left, right = nodes[nid]
        stack.append((left, pth + [nid - V], cds + [0]))
        stack.append((right, pth + [nid - V], cds + [1]))

    depth = max(1, max(len(p) for p in points))
    P = np.full((V, depth), -1, np.int32)
    C = np.zeros((V, depth), np.float32)
    for v in range(V):
        P[v, : len(points[v])] = points[v]
        C[v, : len(codes[v])] = codes[v]
    return P, C, depth


# the row kernels a step runs (`ops.rows.RowOps`: gather, scatter-add), and
# their plain versions, which the kernels are held against
KERNELS, PLAIN = ROW_KERNELS, ROW_PLAIN


@contextlib.contextmanager
def f32_matmul():
    """Full float32 matrix products (no TF32) inside the block; the
    caller's setting comes back after it."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def hs_step(w_in, w_tree, tok, eff_b, points, codes, lr, *, window_ok, dm,
            update_cap, ops=KERNELS):
    """One HS step with the dense update cap; updates w_in [V, D] and
    w_tree [n_inner, D] in place.

    tok [G, PL] token ids (-1 pads), eff_b [G, PL] window draws, points /
    codes [V, T] the tree paths. Returns (loss, pairs) as 0-d tensors.
    """
    G, PL = tok.shape
    V, D = w_in.shape
    T = points.shape[1]
    N = PL * T
    tok_ok = tok >= 0
    tok_safe = torch.where(tok_ok, tok, 0)
    yin = ops.gather(w_in, tok_safe.reshape(-1)).view(G, PL, D)  # centers
    pts = points[tok_safe]  # [G, PL, T] context paths
    label = 1.0 - codes[tok_safe]  # [G, PL, T]
    pts_ok = (pts >= 0) & tok_ok[:, :, None]
    pts_safe = torch.where(pts_ok, pts, 0)
    ptv = ops.gather(w_tree, pts_safe.reshape(-1)).view(G, N, D)

    mask = (window_ok[None] & (dm[None] <= eff_b[:, :, None])
            & tok_ok[:, :, None] & tok_ok[:, None, :]).to(torch.float32)
    # logits of every (center l, context m, level t) over n = m * T + t
    logits = torch.bmm(yin, ptv.transpose(1, 2))  # [G, PL, N]
    gate_n = (mask[:, :, :, None] * pts_ok[:, None, :, :]).reshape(G, PL, N)
    gmat = (label.reshape(G, 1, N) - torch.sigmoid(logits)) * gate_n
    d_yin = torch.bmm(gmat, ptv)  # [G, PL, D]
    d_tree = torch.bmm(gmat.transpose(1, 2), yin)  # [G, N, D]

    # per-row accumulation cap, occupancy riding as the last column: a
    # token counts 1, a tree row its context's window pairs. The JAX step
    # scatters pads as row 0; a pad's gradient rows are exactly zero and a
    # tree pad weighs 0, so pads go in as -1 (dropped) and only the token
    # pads' count is added to row 0's occupancy.
    n_pairs_ctx = mask.sum(1)  # [G, PL] pairs per context
    tweight = (n_pairs_ctx[:, :, None] * pts_ok).reshape(-1, 1)
    ones = torch.ones((G * PL, 1), dtype=torch.float32, device=w_in.device)
    tbuf = ops.scatter_add(
        torch.zeros((V, D + 1), dtype=torch.float32, device=w_in.device),
        tok.reshape(-1), torch.cat([d_yin.reshape(-1, D), ones], 1))
    tbuf[0, D] += (tok < 0).sum()
    rbuf = ops.scatter_add(
        torch.zeros((w_tree.shape[0], D + 1), dtype=torch.float32,
                    device=w_in.device),
        torch.where(pts_ok, pts, -1).reshape(-1),
        torch.cat([d_tree.reshape(-1, D), tweight], 1))
    tok_scale = (update_cap / tbuf[:, D:].clamp(min=1.0)).clamp(max=1.0)
    tree_scale = (update_cap / rbuf[:, D:].clamp(min=1.0)).clamp(max=1.0)
    # in place: the JAX function donates the tables
    w_in.add_(lr * tbuf[:, :D] * tok_scale)
    w_tree.add_(lr * rbuf[:, :D] * tree_scale)

    sgn = 2.0 * label.reshape(G, 1, N) - 1.0
    ll = F.logsigmoid(sgn * logits)
    pairs = mask.sum()
    return -(ll * gate_n).sum() / pairs.clamp(min=1.0), pairs


def hs_block_chunk(w_in, w_tree, walks, points, codes, eff, alpha, min_alpha,
                   t0, total_steps, *, block_walks, window, update_cap=8.0,
                   ops=KERNELS):
    """S = eff.shape[0] HS steps over consecutive walk blocks.

    Step t trains on walks [((t0 + t) % n_blocks) * Bw : + Bw] with
    learning rate max(min_alpha, alpha * (1 - (t0 + t) / total_steps)),
    computed in float32 as the JAX package does. `eff` [S, G, PL] holds
    the window draws in {1..window}. Updates w_in and w_tree in place and
    returns (w_in, w_tree, losses [S], pairs [S]).
    """
    NW, L = walks.shape
    geo = block_geometry(NW, L, block_walks, 1)
    S = eff.shape[0]
    if tuple(eff.shape) != (S, geo.G, geo.PL):
        raise ValueError(f"draws eff {tuple(eff.shape)} do not match {geo}")
    window_ok, dm = window_geometry(L, geo.PL, window, walks.device)
    steps = np.int32(t0) + np.arange(S, dtype=np.int32)
    lrs = np.maximum(
        np.float32(min_alpha),
        np.float32(alpha) * (np.float32(1.0) - steps.astype(np.float32)
                             / np.float32(total_steps)))
    losses, pairs = [], []
    with f32_matmul():
        for s in range(S):
            off = int(steps[s] % geo.n_blocks) * geo.Bw
            tok = walks[off: off + geo.Bw].reshape(geo.G, geo.PL)
            loss, p = hs_step(w_in, w_tree, tok, eff[s], points, codes,
                              float(lrs[s]), window_ok=window_ok, dm=dm,
                              update_cap=float(update_cap), ops=ops)
            losses.append(loss)
            pairs.append(p)
    return w_in, w_tree, torch.stack(losses), torch.stack(pairs)


class HSTrainer:
    """Hierarchical-softmax skip-gram fit (reference hs=1 semantics) over
    a walk corpus on the corpus' device."""

    def __init__(self, embed_size=128, window=5, epochs=5, block_walks=504,
                 alpha=0.025, min_alpha=1e-4, chunk_steps=64, update_cap=8.0,
                 sample=1e-3, seed=0, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh= is not ported to graphembedding_tpu_torch")
        self.embed_size = embed_size
        self.window = window
        self.epochs = epochs
        self.block_walks = block_walks
        self.alpha = alpha
        self.min_alpha = min_alpha
        self.chunk_steps = chunk_steps
        self.update_cap = update_cap
        self.sample = sample  # gensim-default frequent-node subsampling
        self.seed = seed
        self.trained_pairs_ = 0.0

    def fit(self, walks, num_nodes, seed=None, checkpoint_dir=None,
            checkpoint_every=0, metrics=None):
        """Train (w_in [V, D], w_tree [max(V - 1, 1), D]) over the corpus
        walks (int32 [NW, L], -1 pads); returns (w_in, w_tree, losses
        [steps]). The draws come from a `torch.Generator` on the corpus'
        device seeded with `seed` (default `self.seed`)."""
        del checkpoint_every
        for name, value in (("checkpoint_dir", checkpoint_dir),
                            ("metrics", metrics)):
            if value:
                raise NotImplementedError(
                    f"{name}= is not ported to graphembedding_tpu_torch")
        device = walks.device
        gen = torch.Generator(device=device)
        gen.manual_seed(self.seed if seed is None else seed)
        NW, L = walks.shape
        # the JAX HSTrainer's block: no upscaling for large corpora
        bw = fit_block_walks(NW, L, self.block_walks)
        geo = block_geometry(NW, L, bw, 1)
        chunks_per_epoch = max(
            (geo.n_blocks + self.chunk_steps - 1) // self.chunk_steps, 1)
        # the LR decays over the steps executed (whole chunks)
        total_steps = self.epochs * chunks_per_epoch * self.chunk_steps

        # the Huffman tree over the RAW counts (gensim builds the vocab
        # first), then the subsample keep-probabilities
        counts = corpus_counts(walks, num_nodes)
        points, codes, _ = build_huffman(counts)
        points = torch.as_tensor(points, device=device)
        codes = torch.as_tensor(codes, device=device)
        keep_tok = keep_per_token(walks, counts, self.sample)

        D = self.embed_size
        w_in = (torch.rand((num_nodes, D), generator=gen, device=device)
                - 0.5) / D
        w_tree = torch.zeros((max(num_nodes - 1, 1), D), dtype=torch.float32,
                             device=device)
        W = self.window
        losses, pairs = [], []
        t = 0
        for _ in range(self.epochs):
            shuffled = prepare_epoch(walks, keep_tok, gen)
            for _ in range(chunks_per_epoch):
                S = self.chunk_steps
                u = torch.rand((S, geo.G, geo.PL), generator=gen,
                               device=device)
                eff = W - (u * W).to(torch.int32).clamp(0, W - 1)
                _, _, lc, pc = hs_block_chunk(
                    w_in, w_tree, shuffled, points, codes, eff, self.alpha,
                    self.min_alpha, t, total_steps, block_walks=bw,
                    window=W, update_cap=self.update_cap)
                losses.append(lc)
                pairs.append(pc)
                t += S
        self.trained_pairs_ = float(torch.cat(pairs).sum())
        return w_in, w_tree, torch.cat(losses)
