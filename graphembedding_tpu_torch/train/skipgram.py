"""Walk-block skip-gram with negative sampling (SGNS) in PyTorch.

Counterpart of `graphembedding_tpu/train/skipgram.py` (the block
trainer). Each step takes a block of Bw walks from the shuffled corpus,
packs P = 128 // L walks into each of G groups of PL = P*L positions,
gathers their rows of the fused [V, 2D] table (K3), scores all window
pairs and K negatives shared by `nsp` consecutive groups (K1), and
scatter-adds the gradients (K2) with each row's update capped at
`update_cap` sequential-update magnitudes by its occupancy in the step.
The cap takes one of the JAX package's two forms (`cap_mode`, picked by
`sparse_cap_for`): dense, the gradients summed into [V, 2D + 1] and
[V, D + 1] buffers whose last column counts the occupancy, then scaled
and added to the whole table; or sparse, the occupancies summed into two
[V] vectors, each gradient row scaled by its row's cap and scattered
straight into the table, no [V, D]-sized buffer.

The random draws of a chunk of steps (`eff`, the dynamic window, and
`negs`, the shared negatives) are inputs of `sgns_block_chunk_cat`, so a
test can hand it the JAX package's draws; `SkipGramTrainer.fit` makes
them with a `torch.Generator`. On a card a chunk's steps replay one
captured CUDA graph (`train.chunk_graph`, the JAX package's `lax.scan`);
on the CPU, or through the plain versions, they run one by one.

`SkipGramTrainer.fit` checkpoints and resumes (`utils.checkpoint`, with
the generator's states, so a resumed fit is bit-identical to an
uninterrupted one) and logs one metrics line a chunk.

Not ported: `stale_groups`, `use_pallas`/`matmul_bf16`,
`shuffle_mode='block'`, the re-gathering epoch pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

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
from graphembedding_tpu_torch.train.chunk_graph import run_chunk
from graphembedding_tpu_torch.utils.checkpoint import maybe_save, try_restore
from graphembedding_tpu_torch.utils.debug import (
    validate_walks,
    validation_enabled,
)


@dataclass
class SkipGramConfig:
    embed_size: int = 128
    window: int = 5
    negative: int = 5  # gensim-equivalent negatives per pair (expectation)
    k_shared: int = 64  # shared negative rows drawn per sharing group
    neg_share_packs: int = 4  # packing groups sharing one negative set
    epochs: int = 5
    block_walks: int = 4032  # walks per step (Bw), clamped to the corpus
    alpha: float = 0.025
    min_alpha: float = 1e-4
    ns_exponent: float = 0.75
    neg_table_size: int = 1 << 20
    sample: float = 1e-3  # frequent-node subsampling threshold; 0 off
    chunk_steps: int = 64  # steps per chunk of draws
    update_cap: float = 8.0  # per-row cap in sequential-update magnitudes
    # 'dense' | 'sparse' | 'auto': the form of the cap (`sparse_cap_for`);
    # the two forms compute the same update in another order of additions
    cap_mode: str = "auto"
    # over a mesh (parallel/trainer.py): 'rowshard' fetches step t+1's rows
    # before step t's update lands; 'dp' syncs its replicas every this many
    # steps (0: the default, 4)
    rowshard_prefetch: bool = False
    dp_sync_every: int = 4
    seed: int = 0


class StepOps(NamedTuple):
    """The three kernels a step runs: row gather, row scatter-add, SGNS
    block gradients."""

    gather: object
    scatter_add: object
    grads: object


KERNELS = StepOps(gather_rows, scatter_add_rows, sgns_block_grads)
# the plain PyTorch versions, which the kernels are held against
PLAIN = StepOps(gather_rows_plain, scatter_add_rows_plain,
                sgns_block_grads_plain)


def negative_table(counts: np.ndarray, exponent: float = 0.75,
                   size: int = 1 << 20) -> np.ndarray:
    """Pre-sampled unigram^exponent table (word2vec's lookup table),
    built in float64: `table[U{0..size}]` draws from counts^exponent."""
    p = np.power(np.maximum(counts, 0.0), exponent)
    total = p.sum()
    if total <= 0:
        p = np.ones_like(p)
        total = p.sum()
    cum = np.cumsum(p) / total
    return np.searchsorted(
        cum, (np.arange(size) + 0.5) / size, side="left").astype(np.int32)


def inverse_cdf_table(p: torch.Tensor, size: int) -> torch.Tensor:
    """Pre-sampled inverse-CDF lookup table in float32, on p's device.

    The JAX package's `inverse_cdf_table` op for op: weight i's CDF
    boundary lands at slot m_i = floor(cum_i * size + 0.5) and table[j] =
    #{i : m_i <= j}, i.e. searchsorted(cum, (j + 0.5) / size, 'left').
    The f32 sum and cumsum run in another order than XLA's, so a few
    boundary slots can differ by one id (tests/test_torch_line.py counts
    them).
    """
    p = p.to(torch.float32)
    n = p.shape[0]
    p = torch.where(p.sum() > 0, p, torch.ones_like(p))
    cum = torch.cumsum(p, 0) / p.sum().clamp(min=1.0)
    m = torch.floor(cum * size + 0.5).to(torch.int64)
    # boundaries at or after the end mark no slot: they go to an overflow
    # slot that is dropped
    m = torch.where(m < size, m.clamp(min=0), size)
    marks = torch.bincount(m, minlength=size + 1)[:size]
    return torch.cumsum(marks, 0).clamp(0, n - 1).to(torch.int32)


def subsample_keep_probs(counts: np.ndarray, sample: float):
    """word2vec keep-probabilities (sqrt(f/sample) + 1) * sample/f,
    clipped to 1, for corpus frequency f; None when sample <= 0."""
    if sample <= 0:
        return None
    total = max(float(counts.sum()), 1.0)
    f = counts / total
    with np.errstate(divide="ignore", invalid="ignore"):
        p = (np.sqrt(f / sample) + 1.0) * (sample / f)
    return np.where(f > 0, np.minimum(p, 1.0), 0.0).astype(np.float32)


def corpus_counts(walks: torch.Tensor, num_nodes: int) -> np.ndarray:
    """Node frequency in the walk corpus (pads masked), float64 on host."""
    ids = walks.reshape(-1)
    ids = ids[ids >= 0].long()
    return torch.bincount(ids, minlength=num_nodes).cpu().numpy().astype(
        np.float64)


def _subsample_compact(w, kprob, u):
    """Drop tokens where u >= kprob (and pads), then left-compact each
    walk, keeping order; dropped tail positions become -1.

    The stable partition of the JAX package's keyed sort, written as a
    scatter to positions from two prefix sums.
    """
    km = (w >= 0) & (u < kprob)
    kept_pos = torch.cumsum(km.to(torch.int64), dim=1) - 1
    n_kept = kept_pos[:, -1:] + 1
    drop_pos = n_kept + torch.cumsum((~km).to(torch.int64), dim=1) - 1
    pos = torch.where(km, kept_pos, drop_pos)
    out = torch.empty_like(w)
    return out.scatter_(1, pos, torch.where(km, w, -1))


def keep_per_token(walks, counts, sample):
    """f32 [NW, L] keep-probability of each token of the corpus
    (`subsample_keep_probs` of its node; pads read node 0's and are
    dropped by `prepare_epoch`), or None when sample <= 0."""
    keep = subsample_keep_probs(counts, sample)
    if keep is None:
        return None
    return torch.as_tensor(keep, device=walks.device)[walks.clamp(min=0)
                                                      .long()]


def prepare_epoch(walks, keep_tok, generator):
    """One epoch's corpus: the walks in a random order, then, when
    keep_tok is given, each token kept with its probability and every walk
    left-compacted (`_subsample_compact`). Draws a permutation, then
    [NW, L] uniforms, from `generator`."""
    NW, L = walks.shape
    perm = torch.randperm(NW, generator=generator, device=walks.device)
    shuffled = walks[perm]
    if keep_tok is None:
        return shuffled
    u = torch.rand((NW, L), generator=generator, device=walks.device)
    return _subsample_compact(shuffled, keep_tok[perm], u)


class BlockGeometry(NamedTuple):
    Bw: int  # walks per step, rounded to whole packing groups
    P: int  # walks per packing group
    G: int  # packing groups per step
    PL: int  # positions per packing group
    n_blocks: int  # blocks per pass over the corpus
    nsp: int  # packing groups sharing one negative set
    G2: int  # sharing groups per step


def block_geometry(NW: int, L: int, block_walks: int,
                   neg_share_packs: int) -> BlockGeometry:
    """The packing of `sgns_block_chunk_cat`: P = 128 // L walks per
    group, the block clamped to the corpus and rounded down to whole
    groups, `nsp` lowered toward 1 until it divides G."""
    Bw = min(block_walks, NW)
    P = max(min(max(128 // L, 1), Bw), 1)
    G = Bw // P
    Bw = G * P
    nsp = max(int(neg_share_packs), 1)
    while G % nsp:
        nsp -= 1
    return BlockGeometry(Bw, P, G, P * L, max(NW // Bw, 1), nsp, G // nsp)


def window_geometry(L: int, PL: int, window: int, device):
    """Static [PL, PL] window of a packing group: `window_ok` (same walk,
    1 <= |offset| <= window) and `dm` (|offset| within the walk)."""
    i = torch.arange(PL, device=device)[:, None]
    j = torch.arange(PL, device=device)[None, :]
    dm = (j % L - i % L).abs()
    window_ok = (i // L == j // L) & (dm >= 1) & (dm <= window)
    return window_ok, dm


def step_masks(tok, eff_b, neg, window_ok, dm, nsp):
    """Masks of one block: tok [G, PL] token ids (-1 pads), eff_b [G, PL]
    window draws, neg [G2, K] negative ids. Returns (tok_safe, mask
    [G, PL, PL], neg_ok [G2, nsp*PL, K]), the masks float32."""
    G, PL = tok.shape
    G2 = neg.shape[0]
    tok_ok = tok >= 0
    tok_safe = torch.where(tok_ok, tok, 0)
    mask = (window_ok[None] & (dm[None] <= eff_b[:, :, None])
            & tok_ok[:, :, None] & tok_ok[:, None, :]).to(torch.float32)
    tok_n = tok_safe.reshape(G2, nsp * PL)
    neg_ok = (neg[:, None, :] != tok_n[:, :, None]).to(torch.float32)
    return tok_safe, mask, neg_ok


def step_inputs(w_cat, tok, eff_b, neg, window_ok, dm, nsp, ops=KERNELS):
    """Gathered rows and masks of one block.

    tok [G, PL] token ids (-1 pads), eff_b [G, PL] window draws, neg
    [G2, K] negative ids. Returns (tok_safe, y [G, PL, 2D], vn [G2, K, D],
    mask, neg_ok) with mask [G, PL, PL] and neg_ok [G2, nsp*PL, K] float32.
    """
    G, PL = tok.shape
    G2, K = neg.shape
    D = w_cat.shape[1] // 2
    tok_safe, mask, neg_ok = step_masks(tok, eff_b, neg, window_ok, dm, nsp)
    y = ops.gather(w_cat, tok_safe.reshape(-1)).view(G, PL, 2 * D)
    vn = ops.gather(w_cat[:, D:], neg.reshape(-1)).view(G2, K, D)
    return tok_safe, y, vn, mask, neg_ok


# the JAX package's auto rule (`graphembedding_tpu/train/skipgram.py:877-
# 886`): the sparse cap from 2^16 rows on. Kept as it is so that both
# packages train the same steps; the H100's own crossover is in PERF.md
# (`benchmarks/table_scale.py`) and not acted on here.
SPARSE_CAP_MIN_NODES = 1 << 16
CAP_MODES = ("dense", "sparse", "auto")


def sparse_cap_for(cap_mode, num_nodes) -> bool:
    """Whether a fit over num_nodes rows takes the sparse cap: 'sparse', or
    'auto' from SPARSE_CAP_MIN_NODES rows on."""
    if cap_mode not in CAP_MODES:
        raise ValueError(f"cap_mode {cap_mode!r} is not one of {CAP_MODES}")
    if cap_mode == "auto":
        return num_nodes >= SPARSE_CAP_MIN_NODES
    return cap_mode == "sparse"


def negative_weights(mask, neg_w, G2, K):
    """[G2*K]: each negative's event weight, its sharing group's n_pairs *
    neg_w summed over the group's centers (mask [G, PL, PL])."""
    n_pairs = mask.sum(2)
    return (n_pairs.reshape(G2, -1) * neg_w).sum(1)[:, None].expand(
        G2, K).reshape(-1)


def event_rows(d_yin, d_yout, d_vn, mask, neg_w):
    """The rows of a step's two scatters, occupancy riding as the last
    column: tokens [G*PL, 2D+1] = (d_yin | d_yout | 1), negatives
    [G2*K, D+1] = (d_vn | its sharing group's n_pairs * neg_w)."""
    G2, K, D = d_vn.shape
    neg_weight = negative_weights(mask, neg_w, G2, K)
    ones = torch.ones((d_yin.shape[0] * d_yin.shape[1], 1),
                      dtype=torch.float32, device=d_yin.device)
    d_tok = torch.cat([d_yin.reshape(-1, D), d_yout.reshape(-1, D), ones], 1)
    d_neg = torch.cat([d_vn.reshape(-1, D), neg_weight[:, None]], 1)
    return d_tok, d_neg


def capped_update(w_cat, tbuf, nbuf, lr, update_cap):
    """w_cat [V, 2D] += -lr * tbuf's sums and, on the output half, -lr *
    nbuf's, each row scaled by min(1, cap / its occupancy) (the buffers'
    last column); in place."""
    D = nbuf.shape[1] - 1
    tok_scale = (update_cap / tbuf[:, 2 * D:].clamp(min=1.0)).clamp(max=1.0)
    neg_scale = (update_cap / nbuf[:, D:].clamp(min=1.0)).clamp(max=1.0)
    # in place: the JAX function donates the table, so nothing else
    # holds the old values
    w_cat.add_((-lr) * tbuf[:, :2 * D] * tok_scale)
    w_cat[:, D:].add_((-lr) * nbuf[:, :D] * neg_scale)


def sparse_capped_update(w_cat, tok, neg, d_yin, d_yout, d_vn, mask, lr,
                         neg_w, update_cap, ops=KERNELS):
    """The sparse form of the cap (the JAX package's `sparse_cap` step,
    `graphembedding_tpu/train/skipgram.py:503-543`); updates w_cat [V, 2D]
    in place and builds no [V, D]-sized buffer:
    1. two [V] occupancies: 1 a token (pads, -1 in tok, count into row 0,
       as the JAX step scatters them there), and a negative's sharing
       group's n_pairs * neg_w;
    2. each token's and negative's scale min(1, cap / max(occupancy, 1)),
       gathered back from its row;
    3. the pre-scaled rows scattered into the table by `ops.scatter_add`
       (K2): -lr * (d_yin | d_yout) * scale a token into w_cat, then -lr *
       d_vn * scale a negative into its output half. K2 adds each row in
       index order from the table's value, so this is the JAX step's one
       scatter of (tokens | (0 | negatives)) without its zero half.

    The token occupancy is a sum of ones, exact in float32 in any order, so
    an atomic `index_add_` gives the same value run to run; the negatives'
    weights need not sum exactly, so they go through the deterministic
    scatter. The update adds each scaled row into the table where the dense
    form sums a row's rows first and adds once: the two forms agree to
    float32 rounding, not bit for bit."""
    V = w_cat.shape[0]
    G2, K, D = d_vn.shape
    flat, nflat = tok.reshape(-1), neg.reshape(-1)
    tok_safe = flat.clamp(min=0)
    occ_t = torch.zeros(V, dtype=torch.float32, device=w_cat.device)
    occ_t.index_add_(0, tok_safe.long(), torch.ones_like(
        flat, dtype=torch.float32))
    occ_n = ops.scatter_add(
        torch.zeros((V, 1), dtype=torch.float32, device=w_cat.device),
        nflat, negative_weights(mask, neg_w, G2, K)[:, None])[:, 0]
    tok_scale = (update_cap / occ_t[tok_safe].clamp(min=1.0)).clamp(max=1.0)
    neg_scale = (update_cap / occ_n[nflat].clamp(min=1.0)).clamp(max=1.0)
    d_tok = torch.cat([d_yin.reshape(-1, D), d_yout.reshape(-1, D)], 1)
    ops.scatter_add(w_cat, flat, (-lr) * (d_tok * tok_scale[:, None]))
    ops.scatter_add(w_cat[:, D:], nflat,
                    (-lr) * (d_vn.reshape(-1, D) * neg_scale[:, None]))


def sgns_step(w_cat, tok, eff_b, neg, lr, *, window_ok, dm, nsp, neg_w,
              update_cap, sparse_cap=False, ops=KERNELS):
    """One SGNS step, its cap dense or sparse (`sparse_capped_update`);
    updates w_cat in place. lr: a float, or a 0-d float32 tensor of the
    same value (the same bits). Returns (loss, pairs) as 0-d tensors."""
    V, C = w_cat.shape
    D = C // 2
    _, y, vn, mask, neg_ok = step_inputs(
        w_cat, tok, eff_b, neg, window_ok, dm, nsp, ops)
    d_yin, d_yout, d_vn, loss_g = ops.grads(
        y[..., :D], y[..., D:], vn, mask, neg_ok, neg_w)
    pairs = mask.sum()
    loss = loss_g.sum() / pairs.clamp(min=1.0)
    if sparse_cap:
        sparse_capped_update(w_cat, tok, neg, d_yin, d_yout, d_vn, mask, lr,
                             neg_w, update_cap, ops)
        return loss, pairs

    # per-row accumulation cap: a row touched R times in one step moves
    # by its summed update scaled by min(1, cap / R). Occupancy rides as
    # the last column of each scatter: 1 per token, and for a negative
    # row its sharing group's n_pairs * neg_w
    d_tok, d_neg = event_rows(d_yin, d_yout, d_vn, mask, neg_w)
    # The JAX step scatters pads as row 0. A pad's gradient row is exactly
    # zero, so pads go in as -1 (dropped) and only their count is added to
    # row 0's occupancy: the same buffer, without a run of thousands of
    # zero rows on row 0 for the scatter to walk.
    tbuf = ops.scatter_add(
        torch.zeros((V, 2 * D + 1), dtype=torch.float32,
                    device=w_cat.device), tok.reshape(-1), d_tok)
    tbuf[0, 2 * D] += (tok < 0).sum()
    nbuf = ops.scatter_add(
        torch.zeros((V, D + 1), dtype=torch.float32, device=w_cat.device),
        neg.reshape(-1), d_neg)
    capped_update(w_cat, tbuf, nbuf, lr, update_cap)
    return loss, pairs


def window_draws(gen, shape, window):
    """Dynamic-window draws in {1..window}, window - floor(U * window), on
    the generator's device."""
    u = torch.rand(shape, generator=gen, device=gen.device)
    return window - (u * window).to(torch.int32).clamp(0, window - 1)


def step_lrs(t0, S, alpha, min_alpha, total_steps):
    """float32 [S] learning rates max(min_alpha, alpha * (1 - (t0 + s) /
    total_steps)), computed in float32 as the JAX package does."""
    steps = np.int32(t0) + np.arange(S, dtype=np.int32)
    return np.maximum(
        np.float32(min_alpha),
        np.float32(alpha) * (np.float32(1.0) - steps.astype(np.float32)
                             / np.float32(total_steps)))


def chunk_blocks(walks, t0, S, geo):
    """The token blocks of steps t0 .. t0 + S - 1 as [S, G, PL]: step t's
    block is walks [((t0 + t) % n_blocks) * Bw : + Bw], packed as G groups
    of PL positions; one gather of whole blocks."""
    blocks = walks[:geo.n_blocks * geo.Bw].reshape(geo.n_blocks, -1)
    ids = torch.arange(t0, t0 + S, device=walks.device) % geo.n_blocks
    return blocks.index_select(0, ids).view(S, geo.G, geo.PL)


def _chunk_step(b, s, ops, *, nsp, neg_w, update_cap, sparse_cap):
    """Step s of a chunk on its buffers (`chunk_graph.run_chunk`)."""
    return sgns_step(b["w_cat"], b["tokens"][s], b["eff"][s], b["negs"][s],
                     b["lrs"][s], window_ok=b["window_ok"], dm=b["dm"],
                     nsp=nsp, neg_w=neg_w, update_cap=update_cap,
                     sparse_cap=sparse_cap, ops=ops)


def sgns_block_chunk_cat(w_cat, walks, eff, negs, alpha, min_alpha, t0,
                         total_steps, *, block_walks, window, negative,
                         neg_share_packs=1, update_cap=8.0, sparse_cap=False,
                         ops=KERNELS):
    """S = eff.shape[0] SGNS steps over consecutive walk blocks.

    Step t trains on walks [((t0 + t) % n_blocks) * Bw : + Bw] with
    learning rate max(min_alpha, alpha * (1 - (t0 + t) / total_steps)),
    computed in float32 as the JAX package does. `eff` [S, G, PL] holds
    the window draws in {1..window} and `negs` [S, G2, K] the shared
    negative ids. `sparse_cap` picks the cap's form (`sgns_step`).
    Updates w_cat [V, 2D] in place and returns (w_cat, losses [S],
    pairs [S]).

    On a card the S steps through the kernels replay one captured CUDA
    graph (`chunk_graph.run_chunk`); on the CPU, or through the plain
    versions (`ops=PLAIN`), they are launched one by one.
    """
    NW, L = walks.shape
    geo = block_geometry(NW, L, block_walks, neg_share_packs)
    S = eff.shape[0]
    K = negs.shape[2]
    if tuple(eff.shape) != (S, geo.G, geo.PL) or tuple(negs.shape) != (
            S, geo.G2, K):
        raise ValueError(f"draws eff {tuple(eff.shape)} / negs "
                         f"{tuple(negs.shape)} do not match {geo}")
    window_ok, dm = window_geometry(L, geo.PL, window, walks.device)
    lrs = torch.as_tensor(step_lrs(t0, S, alpha, min_alpha, total_steps),
                          device=walks.device)
    inputs = dict(tokens=chunk_blocks(walks, t0, S, geo), eff=eff, negs=negs,
                  lrs=lrs, window_ok=window_ok, dm=dm)
    consts = dict(nsp=geo.nsp, neg_w=float(np.float32(negative)
                                            / np.float32(K)),
                  update_cap=float(update_cap), sparse_cap=bool(sparse_cap))
    losses, pairs = run_chunk(_chunk_step, S, {"w_cat": w_cat}, inputs,
                              ops=ops, plain=PLAIN, consts=consts)
    return w_cat, losses, pairs


def plan_block_walks(NW, L, num_nodes, cfg) -> int:
    """Block size: the configured block, scaled up for large corpora by
    `block_upscale`, fitted to the corpus by `fit_block_walks`."""
    return fit_block_walks(NW, L, block_upscale(NW, num_nodes, cfg))


def fit_block_walks(NW, L, requested) -> int:
    """`requested` walks a block capped at NW // 4, so a small corpus keeps
    >= 4 blocks per epoch, and rounded to a multiple of P = 128 // L."""
    P = max(min(max(128 // L, 1), NW), 1)
    return max((min(requested, max(NW // 4, P)) // P) * P, P)


def block_upscale(NW, num_nodes, cfg) -> int:
    """4x or 8x the configured block for corpora of >= 128 or >= 256
    blocks while the tables stay under 6 GiB (the JAX package's policy,
    kept so both packages train the same blocks)."""
    bw_req = cfg.block_walks
    if num_nodes * 2 * cfg.embed_size * 4 <= (6 << 30):
        if NW >= 256 * cfg.block_walks:
            bw_req = 8 * cfg.block_walks
        elif NW >= 128 * cfg.block_walks:
            bw_req = 4 * cfg.block_walks
    return bw_req


# what a checkpoint of `SkipGramTrainer.fit` holds
SGNS_STATE_KEYS = ("w_in", "w_out", "step", "rng", "rng_epoch")


class Resume:
    """Where a fit restored from a checkpoint picks up its random stream.

    `step` is the checkpoint's step (0 without one). The fit calls
    `epoch_start` before the shuffle of each epoch it trains, and
    `chunks_start` after it. In the first such epoch the generator is set
    to the checkpoint's `rng_epoch` when the checkpoint lies inside the
    epoch (the shuffle is redone, then the generator jumps to `rng`), or
    to `rng` when the checkpoint lies at the epoch's start.
    """

    def __init__(self, state):
        self.state = state
        self.step = 0 if state is None else int(state["step"])
        self._inside = False

    def epoch_start(self, gen, t):
        """Set gen for the epoch starting at step t; returns its state,
        which checkpoints saved in this epoch hold as `rng_epoch`."""
        if self.state is not None:
            self._inside = t < self.step
            gen.set_state(self.state["rng_epoch"] if self._inside
                          else self.state["rng"])
        return gen.get_state()

    def chunks_start(self, gen):
        """After the epoch's shuffle: on to the checkpoint's state, once."""
        if self.state is not None and self._inside:
            gen.set_state(self.state["rng"])
        self.state = None


class SkipGramTrainer:
    """SGNS fit over a walk corpus on the corpus' device."""

    def __init__(self, config: SkipGramConfig | None = None, **kw):
        self.config = config or SkipGramConfig(**kw)
        self.trained_pairs_ = 0.0

    def init_table(self, num_nodes, generator, device):
        """Fused [V, 2D] table, gensim init: w_in ~ (U[0,1) - 0.5) / D,
        w_out = 0."""
        D = self.config.embed_size
        w_in = (torch.rand((num_nodes, D), generator=generator,
                           device=device) - 0.5) / D
        return torch.cat([w_in, torch.zeros_like(w_in)], 1)

    def fit(self, walks, num_nodes, seed=None, checkpoint_dir=None,
            checkpoint_every=0, metrics=None):
        """Train over the corpus walks (int32 [NW, L], -1 pads).

        Returns (w_cat [V, 2D], losses [steps this fit ran]); the step
        draws come from a `torch.Generator` on the corpus' device seeded
        with `seed` (default `config.seed`).

        checkpoint_dir / checkpoint_every: save (w_in, w_out, step) and the
        generator's states every `checkpoint_every` chunks this fit runs,
        and resume from the checkpoint in `checkpoint_dir` when there is
        one (`utils.checkpoint`). One generator draws the table, every
        epoch's shuffle and every chunk's draws, so a checkpoint holds its
        state at the save point (`rng`) and at the start of the epoch being
        trained (`rng_epoch`, to redo that epoch's shuffle): a resumed fit
        equals an uninterrupted one bit for bit. `metrics`: a
        `utils.metrics.MetricsLogger` that gets one `sgns_chunk` line a
        chunk.
        """
        cfg = self.config
        if validation_enabled():
            validate_walks(walks.cpu().numpy(), num_nodes)
        device = walks.device
        gen = torch.Generator(device=device)
        gen.manual_seed(cfg.seed if seed is None else seed)
        NW, L = walks.shape
        bw = plan_block_walks(NW, L, num_nodes, cfg)
        geo = block_geometry(NW, L, bw, cfg.neg_share_packs)
        chunks_per_epoch = max(
            (geo.n_blocks + cfg.chunk_steps - 1) // cfg.chunk_steps, 1)
        # the LR decays over the steps executed: every chunk runs
        # chunk_steps steps, wrapping over the blocks
        total_steps = cfg.epochs * chunks_per_epoch * cfg.chunk_steps
        k_shared = min(cfg.k_shared, num_nodes)
        sparse_cap = sparse_cap_for(cfg.cap_mode, num_nodes)

        # negative table and keep-probabilities from the raw corpus counts
        counts = corpus_counts(walks, num_nodes)
        table = torch.as_tensor(
            negative_table(counts, cfg.ns_exponent, cfg.neg_table_size),
            device=device)
        keep_tok = keep_per_token(walks, counts, cfg.sample)

        D = cfg.embed_size
        state = (try_restore(checkpoint_dir, SGNS_STATE_KEYS)
                 if checkpoint_dir else None)
        if state is None:
            w_cat = self.init_table(num_nodes, gen, device)
        else:
            w_cat = torch.cat([state["w_in"], state["w_out"]], 1).to(device)
        resume = Resume(state)
        losses, pairs = [], []
        t = 0
        n_chunk_calls = 0
        epoch_steps = chunks_per_epoch * cfg.chunk_steps
        for epoch in range(cfg.epochs):
            if t + epoch_steps <= resume.step:
                t += epoch_steps  # a fully resumed epoch: no shuffle
                continue
            rng_epoch = resume.epoch_start(gen, t)
            shuffled = prepare_epoch(walks, keep_tok, gen)
            resume.chunks_start(gen)
            for _ in range(chunks_per_epoch):
                S = cfg.chunk_steps
                if t < resume.step:
                    t += S
                    continue
                eff = window_draws(gen, (S, geo.G, geo.PL), cfg.window)
                negs = table[torch.randint(
                    0, table.shape[0], (S, geo.G2, k_shared),
                    generator=gen, device=device)]
                w_cat, lc, pc = sgns_block_chunk_cat(
                    w_cat, shuffled, eff, negs, cfg.alpha, cfg.min_alpha, t,
                    total_steps, block_walks=bw, window=cfg.window,
                    negative=cfg.negative,
                    neg_share_packs=cfg.neg_share_packs,
                    update_cap=cfg.update_cap, sparse_cap=sparse_cap)
                losses.append(lc)
                pairs.append(pc)
                t += S
                n_chunk_calls += 1
                if metrics is not None:
                    metrics.log(kind="sgns_chunk", epoch=epoch, step=t,
                                loss=round(float(lc.mean()), 5))
                maybe_save(checkpoint_dir, checkpoint_every, n_chunk_calls,
                           lambda: {"w_in": w_cat[:, :D],
                                    "w_out": w_cat[:, D:], "step": t,
                                    "rng": gen.get_state(),
                                    "rng_epoch": rng_epoch})
        self.trained_pairs_ = (float(torch.cat(pairs).sum()) if pairs
                               else 0.0)
        if not losses:  # fully resumed past the end
            return w_cat, torch.zeros(0, device=device)
        return w_cat, torch.cat(losses)
