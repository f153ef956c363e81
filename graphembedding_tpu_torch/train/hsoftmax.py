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

The cap takes one of the JAX package's two forms (`HSTrainer(cap_mode=)`,
picked by `train.skipgram.sparse_cap_for`: the sparse form from 2^16 nodes
under 'auto'): dense, the gradients summed into [V, D] and [n_inner, D]
buffers that are scaled and added to the whole tables; or sparse, each
contribution scaled by its row's cap and scattered straight into the
tables, with no table-sized buffer (`sparse_capped_update`).

The window draws of a chunk (`eff`) are an input of `hs_block_chunk`, so a
test can hand it the JAX package's draws; `HSTrainer.fit` makes them with
a `torch.Generator`, and checkpoints, resumes and logs metrics as
`SkipGramTrainer.fit` does. On a card a chunk's steps replay one captured
CUDA graph (`train.chunk_graph`), captured under the same full-float32
setting; on the CPU, or through the plain versions, they run one by one.

`HSTrainer(mesh=, sync_every=)` trains over a mesh
(`parallel/hsoftmax.py`), always in the dense form: the JAX package's
`sharded_hs_chunk` takes no `sparse_cap` either.

`build_huffman` is the JAX package's tree, bit for bit, built by a
two-queue merge after one sort and filled level by level with numpy, in
place of the JAX function's heap and per-node Python lists.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from graphembedding_tpu_torch.ops.rows import ROW_KERNELS, ROW_PLAIN
from graphembedding_tpu_torch.train.chunk_graph import run_chunk
from graphembedding_tpu_torch.train.skipgram import (
    Resume,
    block_geometry,
    chunk_blocks,
    corpus_counts,
    fit_block_walks,
    keep_per_token,
    prepare_epoch,
    sparse_cap_for,
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
from graphembedding_tpu_torch.utils.profiling import count, span

# what a checkpoint of `HSTrainer.fit` holds
HS_STATE_KEYS = ("w_in", "w_tree", "step", "rng", "rng_epoch")


def build_huffman(counts: np.ndarray):
    """Huffman tree over node frequencies -> (points, codes, depth).

    points[v, t]: inner-node ids (0..V-2) on the path root -> leaf v, -1
    padded; codes[v, t]: 0/1 branch codes aligned with points (0 for the
    first of a merge's two nodes). The JAX package's heap pops (count, id)
    entries, so equal counts break on the node id, as word2vec's
    `create_binary_tree` does; a zero count weighs 1e-9.

    The same tree, bit for bit, by the two-queue merge: the leaves sorted
    stably by (count, id), the inner nodes in the order they are made. The
    merged counts never decrease (float addition is monotone) and inner ids
    grow in that order and exceed every leaf id, so the smaller head of the
    two queues, the leaf on a tie, is the heap's pop; each merge adds the
    same two floats. The paths are then built level by level with numpy.
    """
    V = counts.shape[0]
    if V == 1:
        return (np.full((1, 1), -1, np.int32),
                np.zeros((1, 1), np.float32), 1)
    weight = np.maximum(np.asarray(counts, np.float64), 1e-9)
    order = np.argsort(weight, kind="stable")
    # each queue ends in +inf: an empty queue never wins (the inner one
    # holds the k nodes made so far, the rest still +inf)
    leaf_w = weight[order].tolist() + [float("inf")]
    leaf_id = order.tolist()
    n_inner = V - 1
    inner_w = [float("inf")] * n_inner
    first, second = [0] * n_inner, [0] * n_inner  # node ids of a merge
    i = j = 0  # heads of the leaf and inner queues
    for k in range(n_inner):
        a, b = leaf_w[i], inner_w[j]
        if a <= b:
            w, first[k] = a, leaf_id[i]
            i += 1
        else:
            w, first[k] = b, V + j
            j += 1
        a, b = leaf_w[i], inner_w[j]
        if a <= b:
            inner_w[k], second[k] = w + a, leaf_id[i]
            i += 1
        else:
            inner_w[k], second[k] = w + b, V + j
            j += 1

    children = np.stack([np.asarray(first, np.int64),
                         np.asarray(second, np.int64)], 1)
    # level by level from the root (the last merge), siblings side by side:
    # each node's path (inner ids) and codes, its parent's row and one
    # column more; a leaf's row is its path
    done = []
    nodes = np.array([V + n_inner - 1])
    pts = np.zeros((1, 0), np.int32)
    cds = np.zeros((1, 0), np.int8)
    while nodes.size:
        leaf = nodes < V
        done.append((nodes[leaf], pts[leaf], cds[leaf]))
        at = np.flatnonzero(~leaf)
        inner = nodes[at] - V
        nodes = children[inner].reshape(-1)
        rows, d = np.repeat(at, 2), pts.shape[1]
        pts_next = np.empty((rows.size, d + 1), np.int32)
        pts_next[:, :d] = pts[rows]
        pts_next[:, d] = np.repeat(inner, 2)
        cds_next = np.empty((rows.size, d + 1), np.int8)
        cds_next[:, :d] = cds[rows]
        cds_next[:, d] = np.arange(rows.size) % 2  # the second child: 1
        pts, cds = pts_next, cds_next
    depth = max(1, max(p.shape[1] for _, p, _ in done))
    P = np.full((V, depth), -1, np.int32)
    C = np.zeros((V, depth), np.float32)
    for ids, p, c in done:
        P[ids, :p.shape[1]] = p
        C[ids, :p.shape[1]] = c
    return P, C, depth


# the row kernels a step runs (`ops.rows.RowOps`: gather, scatter-add), and
# their plain versions, which the kernels are held against
KERNELS, PLAIN = ROW_KERNELS, ROW_PLAIN


def sparse_capped_update(w_in, w_tree, tok, tree_ids, d_yin, d_tree, occ_t,
                         occ_r, lr, update_cap, ops=KERNELS):
    """The sparse form of the cap (the JAX package's `sparse_cap` step,
    `graphembedding_tpu/train/hsoftmax.py:207-226`); updates w_in [V, D]
    and w_tree [n_inner, D] in place and builds no table-sized buffer:
    each token's and tree row's scale min(1, cap / max(occupancy, 1)) is
    gathered back from its row of occ_t [V] / occ_r [n_inner], and the
    pre-scaled rows lr * grad * scale go straight into the tables by
    `ops.scatter_add` (K4 up to `ops.rows.SMALL_V_ROWS` rows, else K2).
    tok [N] and tree_ids [N * T] are the scatters' ids, -1 where dropped
    (pads, whose gradient rows are zero). The scatter adds each row into
    the table in index order, where the dense form sums a row's rows first
    and adds once: the two forms agree to float32 rounding, not bit for
    bit."""
    D = w_in.shape[1]
    tok_scale = (update_cap / occ_t[tok.clamp(min=0)].clamp(min=1.0)).clamp(
        max=1.0)
    tree_scale = (update_cap / occ_r[tree_ids.clamp(min=0)].clamp(
        min=1.0)).clamp(max=1.0)
    ops.scatter_add(w_in, tok, lr * d_yin.reshape(-1, D) * tok_scale[:, None])
    ops.scatter_add(w_tree, tree_ids,
                    lr * d_tree.reshape(-1, D) * tree_scale[:, None])


def hs_step(w_in, w_tree, tok, eff_b, points, codes, lr, *, window_ok, dm,
            update_cap, sparse_cap=False, ops=KERNELS, reduce=None):
    """One HS step, its cap dense or sparse (`sparse_capped_update`);
    updates w_in [V, D] and w_tree [n_inner, D] in place.

    tok [G, PL] token ids (-1 pads), eff_b [G, PL] window draws, points /
    codes [V, T] the tree paths, lr a float or a 0-d float32 tensor of the
    same value (the same bits). `reduce`, when given, completes partial
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
    tree_ids = torch.where(pts_ok, pts, -1).reshape(-1)
    if sparse_cap:
        sparse_capped_update(w_in, w_tree, tok.reshape(-1), tree_ids, d_yin,
                             d_tree, occ_t, occ_r, lr, update_cap, ops)
    else:
        tbuf = ops.scatter_add(
            torch.zeros((V, D), dtype=torch.float32, device=w_in.device),
            tok.reshape(-1), d_yin.reshape(-1, D))
        rbuf = ops.scatter_add(
            torch.zeros((w_tree.shape[0], D), dtype=torch.float32,
                        device=w_in.device),
            tree_ids, d_tree.reshape(-1, D))
        tok_scale = (update_cap / occ_t.clamp(min=1.0)).clamp(max=1.0)
        tree_scale = (update_cap / occ_r.clamp(min=1.0)).clamp(max=1.0)
        # in place: the JAX function donates the tables
        w_in.add_(lr * tbuf * tok_scale[:, None])
        w_tree.add_(lr * rbuf * tree_scale[:, None])

    sgn = 2.0 * label.reshape(G, 1, N) - 1.0
    ll = F.logsigmoid(sgn * logits)
    pairs = mask.sum()
    return -(ll * gate_n).sum() / pairs.clamp(min=1.0), pairs


def _chunk_step(b, s, ops, *, update_cap, sparse_cap):
    """Step s of a chunk on its buffers (`chunk_graph.run_chunk`)."""
    return hs_step(b["w_in"], b["w_tree"], b["tokens"][s], b["eff"][s],
                   b["points"], b["codes"], b["lrs"][s],
                   window_ok=b["window_ok"], dm=b["dm"],
                   update_cap=update_cap, sparse_cap=sparse_cap, ops=ops)


def hs_block_chunk(w_in, w_tree, walks, points, codes, eff, alpha, min_alpha,
                   t0, total_steps, *, block_walks, window, update_cap=8.0,
                   sparse_cap=False, ops=KERNELS):
    """S = eff.shape[0] HS steps over consecutive walk blocks.

    Step t trains on walks [((t0 + t) % n_blocks) * Bw : + Bw] with
    learning rate max(min_alpha, alpha * (1 - (t0 + t) / total_steps)),
    computed in float32 as the JAX package does. `eff` [S, G, PL] holds
    the window draws in {1..window}. `sparse_cap` picks the cap's form
    (`hs_step`). Updates w_in and w_tree in place and returns (w_in,
    w_tree, losses [S], pairs [S]).

    On a card the S steps through the kernels replay one captured CUDA
    graph (`chunk_graph.run_chunk`); on the CPU, or through the plain
    versions (`ops=PLAIN`), they are launched one by one.
    """
    NW, L = walks.shape
    geo = block_geometry(NW, L, block_walks, 1)
    S = eff.shape[0]
    if tuple(eff.shape) != (S, geo.G, geo.PL):
        raise ValueError(f"draws eff {tuple(eff.shape)} do not match {geo}")
    with span("train.draws"):
        window_ok, dm = window_geometry(L, geo.PL, window, walks.device)
        lrs = torch.as_tensor(step_lrs(t0, S, alpha, min_alpha,
                                       total_steps), device=walks.device)
        inputs = dict(tokens=chunk_blocks(walks, t0, S, geo), eff=eff,
                      points=points, codes=codes, lrs=lrs,
                      window_ok=window_ok, dm=dm)
    with f32_matmul():
        losses, pairs = run_chunk(
            _chunk_step, S, {"w_in": w_in, "w_tree": w_tree}, inputs,
            ops=ops, plain=PLAIN, consts={"update_cap": float(update_cap),
                                          "sparse_cap": bool(sparse_cap)})
    return w_in, w_tree, losses, pairs


class HSTrainer:
    """Hierarchical-softmax skip-gram fit (reference hs=1 semantics) over
    a walk corpus on the corpus' device, or over a `parallel.mesh.Mesh`
    (`mesh=`: data- and tensor-parallel chunks, `parallel/hsoftmax.py`,
    the replicas synced every `sync_every` steps).

    cap_mode: 'dense' | 'sparse' | 'auto', the form of the update cap on
    one device (`train.skipgram.sparse_cap_for`: 'auto' takes the sparse
    form from `SPARSE_CAP_MIN_NODES` = 2^16 nodes, the JAX rule). A mesh
    fit trains the dense form whatever cap_mode says, as the JAX package's
    does."""

    def __init__(self, embed_size=128, window=5, epochs=5, block_walks=504,
                 alpha=0.025, min_alpha=1e-4, chunk_steps=64, update_cap=8.0,
                 sample=1e-3, seed=0, mesh=None, sync_every=None,
                 cap_mode="auto"):
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
        self.cap_mode = cap_mode
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
        sparse_cap = sparse_cap_for(self.cap_mode, num_nodes)
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

        D = self.embed_size
        with span("train.tables"):
            # the Huffman tree over the RAW counts (gensim builds the vocab
            # first), then the subsample keep-probabilities
            counts = corpus_counts(walks, num_nodes)
            with span("train.tables.huffman"):
                points, codes, _ = build_huffman(counts)
            points = torch.as_tensor(points, device=device)
            codes = torch.as_tensor(codes, device=device)
            keep_tok = keep_per_token(walks, counts, self.sample)
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
            with span("train.prepare"):
                shuffled = prepare_epoch(walks, keep_tok, gen)
            resume.chunks_start(gen)
            count("train.blocks", geo.n_blocks)
            for _ in range(chunks_per_epoch):
                if t < resume.step:
                    t += S
                    continue
                with span("train.draws"):
                    eff = window_draws(draws, (S, geo.G, geo.PL), W)
                args = (w_in, w_tree, shuffled, points, codes, eff,
                        self.alpha, self.min_alpha, t, total_steps)
                if mesh is None:
                    _, _, lc, pc = hs_block_chunk(
                        *args, block_walks=bw, window=W,
                        update_cap=self.update_cap, sparse_cap=sparse_cap)
                else:
                    _, _, lc, pc = sharded_hs_chunk(
                        *args, mesh=mesh, block_walks=bw, window=W,
                        update_cap=self.update_cap,
                        sync_every=self.sync_every)
                losses.append(lc)
                pairs.append(pc)
                t += S
                count("train.steps", S)
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
