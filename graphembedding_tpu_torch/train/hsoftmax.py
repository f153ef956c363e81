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
a `torch.Generator`, and checkpoints, resumes and logs metrics as
`SkipGramTrainer.fit` does.

`HSTrainer(mesh=, sync_every=)` trains over a mesh
(`parallel/hsoftmax.py`). Not ported: the sparse cap form (the dense form
computes the same update at any V).
"""

from __future__ import annotations

import heapq

import numpy as np
import torch
import torch.nn.functional as F

from graphembedding_tpu_torch.ops.rows import ROW_KERNELS, ROW_PLAIN
from graphembedding_tpu_torch.train.skipgram import (
    Resume,
    block_geometry,
    corpus_counts,
    fit_block_walks,
    keep_per_token,
    prepare_epoch,
    step_lrs,
    window_draws,
    window_geometry,
)
from graphembedding_tpu_torch.utils.checkpoint import (
    maybe_save,
    save_sharded,
    try_restore,
    try_restore_sharded,
)
from graphembedding_tpu_torch.utils.debug import (
    validate_walks,
    validation_enabled,
)
from graphembedding_tpu_torch.utils.precision import f32_matmul

# what a checkpoint of `HSTrainer.fit` holds
HS_STATE_KEYS = ("w_in", "w_tree", "step", "rng", "rng_epoch")


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


def hs_step(w_in, w_tree, tok, eff_b, points, codes, lr, *, window_ok, dm,
            update_cap, ops=KERNELS, reduce=None):
    """One HS step with the dense update cap; updates w_in [V, D] and
    w_tree [n_inner, D] in place.

    tok [G, PL] token ids (-1 pads), eff_b [G, PL] window draws, points /
    codes [V, T] the tree paths. `reduce`, when given, completes partial
    logits (over a column slice of the tables) before the sigmoid: the
    mesh's tensor-parallel step sums them over its model axis. Returns
    (loss, pairs) as 0-d tensors.
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
    if reduce is not None:
        logits = reduce(logits)
    gate_n = (mask[:, :, :, None] * pts_ok[:, None, :, :]).reshape(G, PL, N)
    gmat = (label.reshape(G, 1, N) - torch.sigmoid(logits)) * gate_n
    d_yin = torch.bmm(gmat, ptv)  # [G, PL, D]
    d_tree = torch.bmm(gmat.transpose(1, 2), yin)  # [G, N, D]

    # per-row accumulation cap. The gradients go through the scatter rule
    # as contiguous [N, D] rows (16-byte aligned where D % 4 == 0); the
    # occupancy is a 1-D sum apart, as the JAX step keeps it: a token
    # counts 1 (pads as row 0), a tree row its context's window pairs
    # (pads weigh 0). Both are integer-valued floats below 2^24, so any
    # order of summation gives the same bits. The gradient scatters drop
    # pads as -1: a pad's gradient rows are exactly zero.
    n_pairs_ctx = mask.sum(1)  # [G, PL] pairs per context
    tweight = (n_pairs_ctx[:, :, None] * pts_ok).reshape(-1)
    occ_t = torch.zeros(V, dtype=torch.float32, device=w_in.device)
    occ_t.index_add_(0, tok_safe.reshape(-1).long(),
                     torch.ones_like(tok_safe.reshape(-1),
                                     dtype=torch.float32))
    occ_r = torch.zeros(w_tree.shape[0], dtype=torch.float32,
                        device=w_in.device)
    occ_r.index_add_(0, pts_safe.reshape(-1).long(), tweight)
    tbuf = ops.scatter_add(
        torch.zeros((V, D), dtype=torch.float32, device=w_in.device),
        tok.reshape(-1), d_yin.reshape(-1, D))
    rbuf = ops.scatter_add(
        torch.zeros((w_tree.shape[0], D), dtype=torch.float32,
                    device=w_in.device),
        torch.where(pts_ok, pts, -1).reshape(-1), d_tree.reshape(-1, D))
    tok_scale = (update_cap / occ_t.clamp(min=1.0)).clamp(max=1.0)
    tree_scale = (update_cap / occ_r.clamp(min=1.0)).clamp(max=1.0)
    # in place: the JAX function donates the tables
    w_in.add_(lr * tbuf * tok_scale[:, None])
    w_tree.add_(lr * rbuf * tree_scale[:, None])

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
    lrs = step_lrs(t0, S, alpha, min_alpha, total_steps)
    losses, pairs = [], []
    with f32_matmul():
        for s in range(S):
            off = (t0 + s) % geo.n_blocks * geo.Bw
            tok = walks[off: off + geo.Bw].reshape(geo.G, geo.PL)
            loss, p = hs_step(w_in, w_tree, tok, eff[s], points, codes,
                              float(lrs[s]), window_ok=window_ok, dm=dm,
                              update_cap=float(update_cap), ops=ops)
            losses.append(loss)
            pairs.append(p)
    return w_in, w_tree, torch.stack(losses), torch.stack(pairs)


class HSTrainer:
    """Hierarchical-softmax skip-gram fit (reference hs=1 semantics) over
    a walk corpus on the corpus' device, or over a `parallel.mesh.Mesh`
    (`mesh=`: data- and tensor-parallel chunks, `parallel/hsoftmax.py`,
    the replicas synced every `sync_every` steps)."""

    def __init__(self, embed_size=128, window=5, epochs=5, block_walks=504,
                 alpha=0.025, min_alpha=1e-4, chunk_steps=64, update_cap=8.0,
                 sample=1e-3, seed=0, mesh=None, sync_every=None):
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
        if mesh is not None:
            from graphembedding_tpu_torch.parallel.mesh import check_mesh

            check_mesh(mesh)
        self.mesh = mesh
        self.sync_every = sync_every
        self.trained_pairs_ = 0.0

    def _mesh_block_walks(self, NW, L, n):
        """The JAX trainer's block over n data ranks: whole packing groups
        a rank, every rank's slice inside the corpus."""
        if NW < n:
            raise ValueError(
                f"corpus has {NW} walks but the mesh data axis has {n} "
                f"ranks; use a smaller mesh or more walks")
        per = min(max(min(self.block_walks, max(NW // 4, n)) // n, 1),
                  NW // n)
        pk = max(min(max(128 // L, 1), per), 1)
        return max((per // pk) * pk, pk) * n

    def fit(self, walks, num_nodes, seed=None, checkpoint_dir=None,
            checkpoint_every=0, metrics=None):
        """Train (w_in [V, D], w_tree [max(V - 1, 1), D]) over the corpus
        walks (int32 [NW, L], -1 pads); returns (w_in, w_tree, losses
        [steps this fit ran]). The draws come from a `torch.Generator` on
        the corpus' device seeded with `seed` (default `self.seed`).

        checkpoint_dir / checkpoint_every / metrics as in
        `SkipGramTrainer.fit`: the checkpoint holds w_in, w_tree, step and
        the generator's states, and the metrics lines are `hs_chunk`.

        Over a mesh, every rank trains on rank 0's corpus and gets the full
        tables back. The window draws come from a per-rank stream seeded
        from (seed, data rank) (the JAX body folds them by rank); the table
        and the shuffles from the shared stream. Each rank checkpoints its
        own file (`utils.checkpoint.save_sharded`), with the per-rank
        stream's state.
        """
        mesh = self.mesh
        if mesh is not None:
            from graphembedding_tpu_torch.parallel.hsoftmax import (
                sharded_hs_chunk,
            )
            from graphembedding_tpu_torch.parallel.mesh import (
                put_global,
                rank_seed,
            )
            from graphembedding_tpu_torch.parallel.sgns import dp_geometry

            walks = put_global(walks, mesh)
        if validation_enabled():
            validate_walks(walks.cpu().numpy(), num_nodes)
        device = walks.device
        seed = self.seed if seed is None else seed
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        NW, L = walks.shape
        if mesh is None:
            # the JAX HSTrainer's block: no upscaling for large corpora
            bw = fit_block_walks(NW, L, self.block_walks)
            geo = block_geometry(NW, L, bw, 1)
            draws = gen
        else:
            n, di = mesh.size("data"), mesh.get_local_rank("data")
            bw = self._mesh_block_walks(NW, L, n)
            geo = dp_geometry(NW, L, bw, n, 1)
            draws = torch.Generator(device=device).manual_seed(
                rank_seed(seed, di))
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
        w_tree = torch.zeros((max(num_nodes - 1, 1), D),
                             dtype=torch.float32, device=device)
        if mesh is None:
            state = (try_restore(checkpoint_dir, HS_STATE_KEYS)
                     if checkpoint_dir else None)
        else:
            m, mi = mesh.size("model"), mesh.get_local_rank("model")
            if D % m:
                raise ValueError(f"embed_size {D} does not split over the "
                                 f"model axis ({m})")
            cols = slice(mi * D // m, (mi + 1) * D // m)
            w_in, w_tree = w_in[:, cols].clone(), w_tree[:, cols].clone()
            template = dict.fromkeys(HS_STATE_KEYS + ("rng_rank",))
            template.update(w_in=w_in, w_tree=w_tree)
            state = (try_restore_sharded(checkpoint_dir, template, mesh)
                     if checkpoint_dir else None)
        if state is not None:
            w_in = state["w_in"].to(device)
            w_tree = state["w_tree"].to(device)
            if mesh is not None:
                draws.set_state(state["rng_rank"])
        resume = Resume(state)
        W, S = self.window, self.chunk_steps
        losses, pairs = [], []
        t = 0
        n_chunk_calls = 0
        epoch_steps = chunks_per_epoch * S
        for epoch in range(self.epochs):
            if t + epoch_steps <= resume.step:
                t += epoch_steps  # a fully resumed epoch: no shuffle
                continue
            rng_epoch = resume.epoch_start(gen, t)
            shuffled = prepare_epoch(walks, keep_tok, gen)
            resume.chunks_start(gen)
            for _ in range(chunks_per_epoch):
                if t < resume.step:
                    t += S
                    continue
                eff = window_draws(draws, (S, geo.G, geo.PL), W)
                args = (w_in, w_tree, shuffled, points, codes, eff,
                        self.alpha, self.min_alpha, t, total_steps)
                if mesh is None:
                    _, _, lc, pc = hs_block_chunk(
                        *args, block_walks=bw, window=W,
                        update_cap=self.update_cap)
                else:
                    _, _, lc, pc = sharded_hs_chunk(
                        *args, mesh=mesh, block_walks=bw, window=W,
                        update_cap=self.update_cap,
                        sync_every=self.sync_every)
                losses.append(lc)
                pairs.append(pc)
                t += S
                n_chunk_calls += 1
                if metrics is not None:
                    metrics.log(kind="hs_chunk", epoch=epoch, step=t,
                                loss=round(float(lc.mean()), 5))

                def state_now():
                    st = {"w_in": w_in, "w_tree": w_tree, "step": t,
                          "rng": gen.get_state(), "rng_epoch": rng_epoch}
                    if mesh is not None:
                        st["rng_rank"] = draws.get_state()
                    return st

                maybe_save(checkpoint_dir, checkpoint_every, n_chunk_calls,
                           state_now, save=None if mesh is None else
                           (lambda p, st: save_sharded(p, st, mesh)))
        self.trained_pairs_ = (float(torch.cat(pairs).sum()) if pairs
                               else 0.0)
        if mesh is not None and mesh.size("model") > 1:
            from graphembedding_tpu_torch.parallel import comm

            group = mesh.get_group("model")
            w_in, w_tree = (torch.cat(list(comm.all_gather(t_, group)), 1)
                            for t_ in (w_in, w_tree))
        if not losses:  # fully resumed past the end
            return w_in, w_tree, torch.zeros(0, device=device)
        return w_in, w_tree, torch.cat(losses)
