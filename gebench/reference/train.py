"""Plain PyTorch skip-gram fits over a given corpus: walk-block SGNS and
hierarchical softmax, the functions the port's trainers compute.

A fit follows the trainer's published schedule step by step from the
corpus and the fit's seed: the same block packing, the same draws from a
`torch.Generator` seeded with the fit's seed in the same order (the table,
each epoch's permutation and subsample uniforms, each chunk's window
draws and negative slots), the same learning rates and the same per-row
update cap. Everything else (counts, negative table, keep probabilities,
Huffman code) it works out again from the corpus (`tables`). The step
itself is written out in plain products, gathers and `index_add_`.

`matmul` computes every product of a step: `exact` in full float32, or
`tf32`, the same product on operands rounded to TF32 (10 mantissa bits),
the precision a float32 product on a tensor core takes with TF32 on. The
second is the control of `gebench/check.py`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from gebench.reference import tables


def exact(a, b):
    """a @ b in full float32 (TF32 off, whatever torch's setting)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.matmul(a, b)
    finally:
        torch.set_float32_matmul_precision(prev)


def round_tf32(x):
    """float32 x rounded to TF32's 10 mantissa bits, to nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def tf32(a, b):
    """a @ b on TF32-rounded operands, accumulated in float32."""
    return exact(round_tf32(a), round_tf32(b))


MATMULS = {"exact": exact, "tf32": tf32}


@dataclass
class Schedule:
    """The block trainer's constants (the port's and the JAX package's
    defaults, stated in each configuration file)."""

    block_walks: int
    chunk_steps: int
    update_cap: float
    alpha: float
    min_alpha: float
    sample: float
    k_shared: int = 64
    neg_share_packs: int = 4
    ns_exponent: float = 0.75
    neg_table_size: int = 1 << 20
    upscale: bool = True  # SGNS: 4x / 8x blocks for large corpora


def fit_block(NW, L, requested):
    """Walks a block: at most NW // 4 (so a small corpus has four blocks),
    in whole packing groups of P = 128 // L walks."""
    P = max(min(max(128 // L, 1), NW), 1)
    return max((min(requested, max(NW // 4, P)) // P) * P, P)


def upscaled_block(NW, V, D, block_walks):
    """8x the block from 256 blocks of corpus, 4x from 128, while the
    [V, 2D] float32 table stays within 6 GiB."""
    if V * 2 * D * 4 <= (6 << 30):
        if NW >= 256 * block_walks:
            return 8 * block_walks
        if NW >= 128 * block_walks:
            return 4 * block_walks
    return block_walks


def geometry(NW, L, Bw, nsp):
    """(Bw, G, PL, n_blocks, nsp, G2) of a block of Bw walks."""
    Bw = min(Bw, NW)
    P = max(min(max(128 // L, 1), Bw), 1)
    G = Bw // P
    Bw = G * P
    nsp = max(int(nsp), 1)
    while G % nsp:
        nsp -= 1
    return Bw, G, P * L, max(NW // Bw, 1), nsp, G // nsp


def learning_rates(t0, S, alpha, min_alpha, total):
    """float32 [S]: max(min_alpha, alpha * (1 - t / total)) for t = t0 ..
    t0 + S - 1, in float32."""
    t = (np.int32(t0) + np.arange(S, dtype=np.int32)).astype(np.float32)
    return np.maximum(np.float32(min_alpha),
                      np.float32(alpha) * (np.float32(1.0)
                                           - t / np.float32(total)))


def epoch_corpus(walks, keep, gen):
    """The walks permuted, then each token kept where a uniform falls
    under its keep probability, the kept ones moved to the front of their
    walk in order and the rest set to -1."""
    NW, L = walks.shape
    perm = torch.randperm(NW, generator=gen, device=walks.device)
    w = walks[perm]
    u = torch.rand((NW, L), generator=gen, device=walks.device)
    kept = (w >= 0) & (u < keep[w.clamp(min=0).long()])
    pos = torch.arange(L, device=walks.device).expand(NW, L)
    order = torch.argsort(torch.where(kept, pos, pos + L), dim=1)
    out = torch.gather(w, 1, order)
    n_kept = kept.sum(1, keepdim=True)
    return torch.where(pos < n_kept, out, torch.full_like(out, -1))


def window_draws(gen, shape, window):
    """Reduced windows b = window - floor(U * window), in 1 .. window."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return window - (u * window).to(torch.int32).clamp(0, window - 1)


def pair_mask(tok, eff, L, window):
    """float32 [G, PL, PL]: position m is a context of center l when both
    are tokens of one walk, 1 <= |offset| <= the center's draw."""
    G, PL = tok.shape
    i = torch.arange(PL, device=tok.device)
    off = (i[None, :] % L - i[:, None] % L).abs()
    same = (i[:, None] // L) == (i[None, :] // L)
    ok = tok >= 0
    m = (same[None] & (off[None] >= 1) & (off[None] <= window)
         & (off[None] <= eff[:, :, None]) & ok[:, :, None] & ok[:, None, :])
    return m.to(torch.float32)


def capped_add(table, ids, rows, occupancy, scale_sign, update_cap):
    """table[ids[n]] += scale_sign * rows[n] * min(1, cap / max(occ, 1)),
    the occupancy read at each row's id; ids < 0 are left out."""
    keep = ids >= 0
    ids = ids[keep].long()
    scale = (update_cap / occupancy[ids].clamp(min=1.0)).clamp(max=1.0)
    table.index_add_(0, ids, scale_sign * rows[keep] * scale[:, None])


def sgns_step(w, tok, eff, neg, lr, *, L, window, nsp, neg_w, update_cap,
              mm):
    """One SGNS step on the fused table w [V, 2D] (input | output rows):
    tok [G, PL] tokens (-1 pads), eff [G, PL] window draws, neg [G2, K]
    negatives shared by the nsp groups of a sharing group."""
    V, D2 = w.shape
    D = D2 // 2
    G, PL = tok.shape
    G2, K = neg.shape
    mask = pair_mask(tok, eff, L, window)
    safe = tok.clamp(min=0).long()
    yin, yout = w[safe, :D], w[safe, D:]  # [G, PL, D]
    vn = w[neg.long(), D:]  # [G2, K, D]
    # positives: -log sigmoid(u . v) over the window pairs
    g_pos = (torch.sigmoid(mm(yin, yout.transpose(1, 2))) - 1.0) * mask
    # negatives: each center against its sharing group's K shared rows,
    # weighted by its pairs * negative / K, a row equal to it left out
    yin_n = yin.reshape(G2, nsp * PL, D)
    safe_n = safe.reshape(G2, nsp * PL)
    w_neg = (mask.sum(2).reshape(G2, nsp * PL) * neg_w)[:, :, None]
    neg_ok = (neg[:, None, :].long() != safe_n[:, :, None]).to(torch.float32)
    g_neg = torch.sigmoid(mm(yin_n, vn.transpose(1, 2))) * w_neg * neg_ok
    d_in = mm(g_pos, yout) + mm(g_neg, vn).reshape(G, PL, D)
    d_out = mm(g_pos.transpose(1, 2), yin)
    d_neg = mm(g_neg.transpose(1, 2), yin_n)
    # the cap: a token counts 1 (a pad counts toward row 0), a negative
    # its sharing group's pairs * neg_w
    occ_t = torch.zeros(V, dtype=torch.float32, device=w.device)
    occ_t.index_add_(0, safe.reshape(-1), torch.ones(G * PL,
                                                    device=w.device))
    occ_n = torch.zeros(V, dtype=torch.float32, device=w.device)
    n_weight = (mask.sum(2).reshape(G2, -1) * neg_w).sum(1)
    occ_n.index_add_(0, neg.reshape(-1).long(),
                     n_weight[:, None].expand(G2, K).reshape(-1))
    d_tok = torch.cat([d_in, d_out], 2).reshape(G * PL, 2 * D)
    flat = tok.reshape(-1)
    neg_flat = neg.reshape(-1)
    capped_add(w, flat, d_tok, occ_t, -lr, update_cap)
    out = w[:, D:]
    # index_add_ into a column slice: through a contiguous copy
    out_c = out.contiguous()
    capped_add(out_c, neg_flat, d_neg.reshape(G2 * K, D), occ_n, -lr,
               update_cap)
    out.copy_(out_c)


def sgns_fit(walks, num_nodes, *, D, window, negative, epochs, seed,
             sched: Schedule, matmul="exact", drop_half=False):
    """(w_in [V, D], w_out [V, D], w_in at the start) of a walk-block SGNS
    fit over `walks` (int32 [NW, L] on a device), its draws from a
    generator seeded with `seed`. `drop_half` leaves out the second half
    of every step's walks (a planted fault)."""
    mm = MATMULS[matmul]
    device = walks.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    NW, L = walks.shape
    V = num_nodes
    req = (upscaled_block(NW, V, D, sched.block_walks) if sched.upscale
           else sched.block_walks)
    Bw, G, PL, n_blocks, nsp, G2 = geometry(
        NW, L, fit_block(NW, L, req), sched.neg_share_packs)
    S = sched.chunk_steps
    chunks = max((n_blocks + S - 1) // S, 1)
    total = epochs * chunks * S
    K = min(sched.k_shared, V)
    neg_w = float(np.float32(negative) / np.float32(K))

    counts = tables.corpus_counts(walks, V)
    table = torch.as_tensor(tables.negative_table(
        counts, sched.ns_exponent, sched.neg_table_size), device=device)
    keep = torch.as_tensor(tables.keep_probs(counts, sched.sample),
                           device=device)
    w_in0 = (torch.rand((V, D), generator=gen, device=device) - 0.5) / D
    w = torch.cat([w_in0, torch.zeros_like(w_in0)], 1)
    t = 0
    for _ in range(epochs):
        corpus = epoch_corpus(walks, keep, gen)
        blocks = corpus[:n_blocks * Bw].reshape(n_blocks, G, PL)
        for _ in range(chunks):
            eff = window_draws(gen, (S, G, PL), window)
            negs = table[torch.randint(0, table.shape[0], (S, G2, K),
                                       generator=gen, device=device)]
            lrs = learning_rates(t, S, sched.alpha, sched.min_alpha, total)
            for s in range(S):
                tok = blocks[(t + s) % n_blocks]
                if drop_half:
                    tok = tok.clone()
                    tok[G // 2:] = -1
                sgns_step(w, tok, eff[s], negs[s], float(lrs[s]), L=L,
                          window=window, nsp=nsp, neg_w=neg_w,
                          update_cap=sched.update_cap, mm=mm)
            t += S
    return w[:, :D], w[:, D:], w_in0


def hs_step(w_in, w_tree, tok, eff, points, codes, lr, *, L, window,
            update_cap, mm):
    """One hierarchical-softmax step: every (center, context) window pair
    scores the center's row against the inner nodes on the context's
    Huffman path; loss -log sigmoid(+-u . w) by the branch taken."""
    V, D = w_in.shape
    G, PL = tok.shape
    T = points.shape[1]
    mask = pair_mask(tok, eff, L, window)
    ok = tok >= 0
    safe = tok.clamp(min=0).long()
    yin = w_in[safe]  # [G, PL, D]
    pts = points[safe]  # [G, PL, T]
    label = 1.0 - codes[safe]
    pts_ok = (pts >= 0) & ok[:, :, None]
    pts_safe = torch.where(pts_ok, pts, 0).long()
    ptv = w_tree[pts_safe].reshape(G, PL * T, D)
    logits = mm(yin, ptv.transpose(1, 2))  # [G, PL, PL * T]
    gate = (mask[:, :, :, None] * pts_ok[:, None, :, :]).reshape(
        G, PL, PL * T)
    g = (label.reshape(G, 1, PL * T) - torch.sigmoid(logits)) * gate
    d_in = mm(g, ptv)  # [G, PL, D]
    d_tree = mm(g.transpose(1, 2), yin)  # [G, PL * T, D]
    # the cap: a token counts 1 (a pad toward row 0), an inner node the
    # window pairs of the contexts whose path holds it
    occ_t = torch.zeros(V, dtype=torch.float32, device=w_in.device)
    occ_t.index_add_(0, safe.reshape(-1), torch.ones(G * PL,
                                                    device=w_in.device))
    occ_r = torch.zeros(w_tree.shape[0], dtype=torch.float32,
                        device=w_in.device)
    ctx_pairs = mask.sum(1)  # [G, PL]
    occ_r.index_add_(0, pts_safe.reshape(-1),
                     (ctx_pairs[:, :, None] * pts_ok).reshape(-1))
    capped_add(w_in, tok.reshape(-1), d_in.reshape(-1, D), occ_t, lr,
               update_cap)
    capped_add(w_tree, torch.where(pts_ok, pts, -1).reshape(-1),
               d_tree.reshape(-1, D), occ_r, lr, update_cap)


def hs_fit(walks, num_nodes, *, D, window, epochs, seed, sched: Schedule,
           matmul="exact", drop_half=False):
    """(w_in [V, D], w_tree [V - 1, D], w_in at the start) of a
    hierarchical-softmax fit over `walks`, its draws from a generator
    seeded with `seed` (the table, then per epoch the permutation and the
    subsample, per chunk the window draws)."""
    mm = MATMULS[matmul]
    device = walks.device
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    NW, L = walks.shape
    V = num_nodes
    Bw, G, PL, n_blocks, _, _ = geometry(
        NW, L, fit_block(NW, L, sched.block_walks), 1)
    S = sched.chunk_steps
    chunks = max((n_blocks + S - 1) // S, 1)
    total = epochs * chunks * S

    counts = tables.corpus_counts(walks, V)
    points, codes = tables.huffman_code(counts)
    points = torch.as_tensor(points, device=device)
    codes = torch.as_tensor(codes, device=device)
    keep = torch.as_tensor(tables.keep_probs(counts, sched.sample),
                           device=device)
    w_in0 = (torch.rand((V, D), generator=gen, device=device) - 0.5) / D
    w_in = w_in0.clone()
    w_tree = torch.zeros((max(V - 1, 1), D), dtype=torch.float32,
                         device=device)
    t = 0
    for _ in range(epochs):
        corpus = epoch_corpus(walks, keep, gen)
        blocks = corpus[:n_blocks * Bw].reshape(n_blocks, G, PL)
        for _ in range(chunks):
            eff = window_draws(gen, (S, G, PL), window)
            lrs = learning_rates(t, S, sched.alpha, sched.min_alpha, total)
            for s in range(S):
                tok = blocks[(t + s) % n_blocks]
                if drop_half:
                    tok = tok.clone()
                    tok[G // 2:] = -1
                hs_step(w_in, w_tree, tok, eff[s], points, codes,
                        float(lrs[s]), L=L, window=window,
                        update_cap=sched.update_cap, mm=mm)
            t += S
    return w_in, w_tree, w_in0
