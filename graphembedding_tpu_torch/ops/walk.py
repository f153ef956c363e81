"""Random walks in plain PyTorch: uniform, weighted and (p,q) second order.

Counterpart of `graphembedding_tpu/ops/walk.py`. Every walker advances in
lockstep, one hop a step of a Python loop over the walk's length:

  * `uniform_walks` (JAX `uniform_walks`, DeepWalk): the next hop uniform
    over the out-neighbors; two gathers (offset, degree), one uniform, one
    gather from `col_idx`.
  * `weighted_walks` (JAX `weighted_walks`): first order, weighted, one
    alias draw a hop from the per-row tables (`ops.alias.alias_draw`).
  * `node2vec_walks` (JAX `node2vec_walks`): the exact (p,q) walk. Each
    candidate of cur's padded row scores w * {1/p, 1, 1/q} by its class
    against prev, and a Gumbel-max draw picks one. Membership in N(prev)
    is exact: a batched `torch.searchsorted` of every candidate in prev's
    sorted row (its -1 pads raised to a sentinel above every id), in place
    of the JAX package's chunked equality test.
  * `node2vec_walks_rejection` (JAX `node2vec_walks_rejection`, the
    reference's `node2vec_walk2`): alias proposals from N(cur) accepted at
    factor / envelope, with the prev-point envelope mixture or the plain
    upper bound, membership by binary search in the CSR (`csr_find`) or in
    prev's resident padded row, and the JAX package's analytic retry
    budget. Its retry loop is a fixed number of rounds, walkers already
    done masked out: the same law as the JAX `while_loop`, with no host
    sync a round.

A walk that reaches a node without out-edges stops there and the rest of
its row is -1. Walks are int32 [B, L]. The draws come from a
`torch.Generator`, so the walks follow the JAX package's distributions,
not its values; two runs from one seed are bit-identical.

Those loops are the plain versions (`*_plain`), which the CPU runs. On a
card each public function launches one hand-written kernel a corpus
(`csrc/walk.cu`): K6 for `uniform_walks` and `weighted_walks`, K7 for
`node2vec_walks`, K8 for `node2vec_walks_rejection` (K9, the multilayer
walk, is in `models/struc2vec.py`). A kernel draws its uniforms from
Philox keyed by a seed drawn from the caller's generator, so its walks
follow the same law as the plain version's but not its values; given
`draws=`, the plain version's own uniforms in its order and layout
(`*_draw_shapes`, recorded by `record_draws`), kernel and plain version
walk the same corpus. A CUDA tensor reaches a kernel or an exception,
never a plain loop. None of these kernels replaces a Pallas kernel: each
replaces the JAX package's lockstep `lax.scan`.
"""

from __future__ import annotations

import math

import torch

from graphembedding_tpu_torch.kernels import build as kb
from graphembedding_tpu_torch.ops.alias import alias_draw

_LANE = 128  # the JAX package's neighbor-axis padding, for its thresholds
_SENTINEL = torch.iinfo(torch.int32).max  # above every node id
PQ_BUDGET_BYTES = 4 << 30  # the JAX package's device-memory budget


def _safe(cur):
    """Dead (-1) walker ids clamped to 0 for gathers; callers mask."""
    return cur.clamp(min=0)


def _nonempty(table, fill):
    """`table`, or one `fill` slot where it is empty: an edgeless graph
    still needs a slot to gather from (every read of it is masked)."""
    if table.shape[0]:
        return table
    return torch.full((1,), fill, dtype=table.dtype, device=table.device)


def _first_column(starts, length):
    out = torch.empty((starts.shape[0], length), dtype=torch.int32,
                      device=starts.device)
    out[:, 0] = starts.to(torch.int32)
    return out


def csr_find(row_ptr, col_idx, degree, rows, values, *, max_degree):
    """Position of `values[...]` in CSR row `rows[...]` (any one shape).

    A binary search over the sorted columns of each row, in a fixed
    `bit_length(max_degree)` steps. `rows` must be valid (>= 0). Returns
    (found bool, idx int64): `idx` is the global CSR slot of the match,
    meaningful only where found.
    """
    col = _nonempty(col_idx, -1)
    last = col.shape[0] - 1
    lo = row_ptr[rows]
    end = lo + degree[rows]
    hi = end
    for _ in range(max(int(max_degree).bit_length(), 1)):
        active = lo < hi
        mid = (lo + hi) // 2
        go_right = col[mid.clamp(max=last)] < values
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    found = (lo < end) & (col[lo.clamp(max=last)] == values)
    return found, lo


def csr_contains(row_ptr, col_idx, degree, rows, values, *, max_degree):
    """Is `values[...]` in CSR row `rows[...]`?"""
    found, _ = csr_find(row_ptr, col_idx, degree, rows, values,
                        max_degree=max_degree)
    return found


def sorted_rows(rows):
    """Padded neighbor rows (ascending ids, then -1 pads) with the pads
    raised to a sentinel above every id, so each row sorts ascending."""
    return torch.where(rows >= 0, rows, _SENTINEL)


def rows_contain(srt, cand):
    """cand[b, j] in srt[b, :]? for rows from `sorted_rows` (exact; a -1
    candidate is in no row)."""
    pos = torch.searchsorted(srt, cand.contiguous())
    return srt.gather(1, pos.clamp_(max=srt.shape[1] - 1)) == cand


# --------------------------------------------------------------------------- #
# the uniforms: from a generator, or shared draws
# --------------------------------------------------------------------------- #


def draw_count(shapes) -> int:
    """The number of uniforms in a draws layout (a list of shapes)."""
    return sum(math.prod(s) for s in shapes)


def record_draws(shapes, generator):
    """The uniforms a plain walk draws from `generator`, in its order, as
    one flat float32 tensor on the generator's device: each shape of the
    layout drawn by one `torch.rand` call, flattened, concatenated. A plain
    version given these as `draws=` walks what it walks from a generator
    in the same state, and its kernel reads the same numbers."""
    dev = generator.device
    parts = [torch.rand(s, generator=generator, device=dev).reshape(-1)
             for s in shapes]
    return torch.cat(parts) if parts else torch.empty(0, device=dev)


class Uniforms:
    """A plain walk's source of uniforms: `torch.rand` on `generator`, or
    the next slice of `draws` (flat float32, laid out by the walk's
    `*_draw_shapes`), exactly one of the two."""

    def __init__(self, generator, draws, shapes, device):
        if (generator is None) == (draws is None):
            raise ValueError("pass exactly one of generator= and draws=")
        if draws is not None:
            check_draws(draws, shapes, device, "walk")
        self.generator, self.draws, self.device = generator, draws, device
        self.at = 0

    def __call__(self, shape):
        shape = (shape,) if isinstance(shape, int) else tuple(shape)
        if self.draws is None:
            return torch.rand(shape, generator=self.generator,
                              device=self.device)
        n = math.prod(shape)
        out = self.draws[self.at:self.at + n].view(shape)
        self.at += n
        return out


def check_draws(draws, shapes, device, name):
    """Raise unless `draws` is a contiguous float32 tensor on `device`
    holding the layout's uniforms."""
    want = draw_count(shapes)
    if (draws.dtype != torch.float32 or draws.device != device
            or draws.dim() != 1 or not draws.is_contiguous()
            or draws.numel() != want):
        raise ValueError(
            f"{name}: draws must be a contiguous float32 [{want}] tensor on "
            f"{device}, got {draws.dtype} {tuple(draws.shape)} on "
            f"{draws.device}")


def uniform_draw_shapes(B, length):
    """`uniform_walks`' draws: one [B] a hop."""
    return [(B,)] * max(length - 1, 0)


def weighted_draw_shapes(B, length):
    """`weighted_walks`' draws: [B] for the slot, [B] for the coin, a
    hop."""
    return [(B,), (B,)] * max(length - 1, 0)


def node2vec_draw_shapes(B, length, D):
    """`node2vec_walks`' draws: one [B, D] a hop, a uniform a candidate."""
    return [(B, D)] * max(length - 1, 0)


def rejection_draw_shapes(B, length, p, q, *, envelope, row_slots):
    """`node2vec_walks_rejection`'s draws: [B] and [B] for the first hop's
    alias draw, then a hop, a round: [B, P] for the slots, [B, P] for the
    alias coins (unless `row_slots`), [B, P] for the prev point's coins
    (`envelope`), [B, P] for the acceptances; P and the rounds are
    `rejection_budget`'s."""
    if length < 2:
        return []
    n_prop, max_tries = rejection_budget(p, q, envelope=envelope)
    n_rounds = -(-max_tries // n_prop)
    k = 2 + (not row_slots) + bool(envelope)
    return [(B,), (B,)] + [(B, n_prop)] * (k * n_rounds * (length - 2))


# --------------------------------------------------------------------------- #
# the plain versions (the kernels' oracles; the CPU's walks)
# --------------------------------------------------------------------------- #


def uniform_walks_plain(row_ptr, col_idx, degree, starts, *, length,
                        generator=None, draws=None):
    """DeepWalk walks from `starts` (int [B]): uniform next hop.

    row_ptr is int64 [V+1], col_idx int32 [E], degree int32 [V]. Returns
    int32 [B, length]. The uniforms come from `generator`, or from
    `draws` (`uniform_draw_shapes`).
    """
    device = starts.device
    cur = starts.to(torch.int64)
    rand = Uniforms(generator, draws,
                     uniform_draw_shapes(cur.shape[0], length), device)
    num_edges = col_idx.shape[0]
    col = _nonempty(col_idx, -1).to(torch.int64)
    deg_all = degree.to(torch.int64)
    out = _first_column(cur, length)
    for t in range(1, length):
        alive = cur >= 0
        safe = _safe(cur)
        deg = torch.where(alive, deg_all[safe], 0)
        u = rand(cur.shape)
        pick = torch.minimum((u * deg.to(torch.float32)).to(torch.int64),
                             (deg - 1).clamp(min=0))
        # a node without out-edges may sit at row_ptr == E: clamp the read
        slot = (row_ptr[safe] + pick).clamp(max=max(num_edges - 1, 0))
        cur = torch.where(deg > 0, col[slot], -1)
        out[:, t] = cur.to(torch.int32)
    return out


def weighted_walks_plain(row_ptr, col_idx, degree, accept, alias, starts,
                         *, length, generator=None, draws=None):
    """First-order weighted walks: one alias draw a hop from the per-row
    tables (`accept` f32 [E], `alias` i32 [E], aligned to the CSR); the
    uniforms from `generator` or `draws` (`weighted_draw_shapes`)."""
    device = starts.device
    cur = starts.to(torch.int64)
    rand = Uniforms(generator, draws,
                     weighted_draw_shapes(cur.shape[0], length), device)
    col = _nonempty(col_idx, -1)
    accept, alias = _nonempty(accept, 1.0), _nonempty(alias, 0)
    deg_all = degree.to(torch.int64)
    out = _first_column(cur, length)
    for t in range(1, length):
        safe = _safe(cur)
        deg = torch.where(cur >= 0, deg_all[safe], 0)
        rp = row_ptr[safe]
        u1 = rand(cur.shape)
        u2 = rand(cur.shape)
        slot = alias_draw(accept, alias, rp, deg.clamp(min=1), u1, u2)
        nxt = col[(rp + slot).clamp(max=col.shape[0] - 1)]
        cur = torch.where(deg > 0, nxt.to(torch.int64), -1)
        out[:, t] = cur.to(torch.int32)
    return out


def _gumbel_scores(w, u):
    """log w + Gumbel(0, 1) noise -log(-log(u)), u clamped to [1e-20, 1);
    -inf where w <= 0."""
    score = torch.where(w > 0, torch.log(w.clamp(min=1e-30)), -math.inf)
    return score - torch.log(-torch.log(u.clamp(min=1e-20)))


def _gumbel_pick(w, generator):
    """A column of each row of `w` (f32 [B, D]) drawn with probability
    proportional to w (Gumbel-max); rows with no positive w give 0."""
    u = torch.rand(w.shape, generator=generator, device=w.device)
    return _gumbel_scores(w, u).argmax(dim=1, keepdim=True)


def node2vec_walks_plain(degree, nbr, nbr_w, starts, p, q, *, length,
                         generator=None, draws=None):
    """Exact (p,q)-biased second-order walks (Grover & Leskovec 2016).

    `nbr` i32 [V, Dmax] (pad -1) and `nbr_w` f32 [V, Dmax] (pad 0) are the
    padded neighbor rows (`Graph.neighbor_matrix`). For a walker at `cur`
    that came from `prev`, each neighbor x of cur weighs

        w(cur, x) * {1/p if x == prev, 1 if x in N(prev), 1/q otherwise}

    and one Gumbel-max draw over cur's row picks the next hop (ties to the
    first column). The first hop is a plain weighted draw. The uniforms
    come from `generator` or `draws` (`node2vec_draw_shapes`). (The JAX
    signature's row_ptr and col_idx are not taken: the padded rows hold
    all the sampler reads.)
    """
    inv_p, inv_q = 1.0 / float(p), 1.0 / float(q)
    cur = starts.to(torch.int64)
    rand = Uniforms(generator, draws, node2vec_draw_shapes(
        cur.shape[0], length, nbr.shape[1]), starts.device)
    deg_all = degree.to(torch.int64)
    out = _first_column(cur, length)
    prev = None
    for t in range(1, length):
        safe = _safe(cur)
        cand = nbr[safe]  # [B, D]
        w = nbr_w[safe]
        if prev is not None:
            is_prev = cand == prev[:, None]
            in_prev = rows_contain(sorted_rows(nbr[_safe(prev)]), cand)
            w = w * torch.where(is_prev, inv_p,
                                torch.where(in_prev, 1.0, inv_q))
        pick = _gumbel_scores(w, rand(w.shape)).argmax(dim=1, keepdim=True)
        nxt = cand.gather(1, pick)[:, 0]
        deg = torch.where(cur >= 0, deg_all[safe], 0)
        prev, cur = cur, torch.where(deg > 0, nxt.to(torch.int64), -1)
        out[:, t] = cur.to(torch.int32)
    return out


def rejection_budget(p, q, *, envelope):
    """(proposals a round, retry budget) of the rejection sampler, as the
    JAX package sizes them from the analytic acceptance floor of the
    active form: overflow <= ~2e-3 a hop, one round wide enough to cover
    the budget where it can, at most 64 tries in all."""
    inv_p, inv_q = 1.0 / float(p), 1.0 / float(q)
    if envelope:
        beta = max(1.0, inv_q)
        floor = min(inv_p / max(inv_p, beta), 1.0 / beta, inv_q / beta)
    else:
        floor = min(inv_p, 1.0, inv_q) / max(inv_p, 1.0, inv_q)
    floor = min(max(floor, 1e-6), 1.0 - 1e-9)
    need = max(1, math.ceil(math.log(2e-3) / math.log(1.0 - floor)))
    n_prop = int(min(max(need, 8), 32))
    rounds = max(1, math.ceil(
        math.log(2e-3) / (n_prop * math.log(1.0 - floor))))
    return n_prop, int(min(rounds * n_prop, 64))


def rejection_constants(p, q, *, envelope):
    """(a_coef, beta, acceptance of prev, of a shared neighbor, of any
    other) of the rejection sampler's form: a proposal of class c is
    accepted with probability factor(c) / envelope(c), factor in {1/p, 1,
    1/q}; the envelope is beta = max(1, 1/q) plus a_coef = max(1/p - beta,
    0) at prev (the mixture), or max(1/p, 1, 1/q) everywhere (the upper
    bound). Python floats: the plain version and the kernel compare each
    uniform with the same float32 of each."""
    inv_p, inv_q = 1.0 / float(p), 1.0 / float(q)
    beta = max(1.0, inv_q)
    a_coef = max(inv_p - beta, 0.0)
    if envelope:
        return (a_coef, beta, inv_p / (beta + a_coef), 1.0 / beta,
                inv_q / beta)
    ub = max(inv_p, 1.0, inv_q)
    return a_coef, beta, inv_p / ub, 1.0 / ub, inv_q / ub


def node2vec_walks_rejection_plain(row_ptr, col_idx, degree, accept, alias,
                                   starts, p, q, *, length, max_degree,
                                   generator=None, draws=None,
                                   edge_weight=None, wsum=None,
                                   envelope=None, nbr=None,
                                   uniform_rows=False):
    """Rejection-sampling (p,q) walks (reference `node2vec_walk2`).

    A proposal is a weighted first-order draw from N(cur) (the alias
    tables). It is accepted with probability factor(y) / envelope(y),
    factor in {1/p, 1, 1/q} by the class of y against prev. Each round
    draws a batch of candidates a walker and takes the first accepted
    one; after the last round a walker with none accepted keeps the last
    proposal (the overflow bias the budget bounds).

    ``envelope=True``: the prev-point mixture. Propose prev with the
    excess mass a = max(1/p - beta, 0) * w(cur, prev), beta = max(1,
    1/q), and everything else from the alias draw at envelope beta; the
    per-class acceptance is then {prev: 1, shared: 1/beta, other:
    (1/q)/beta}. ``envelope=False``: the upper-bound form, envelope
    max(1/p, 1, 1/q) (`rejection_constants`). ``None`` takes the mixture
    exactly when `wsum` is given (its mass needs the cur->prev weight and
    the row sums: pass `edge_weight` f32 [E] and `wsum` f32 [V] for a
    weighted graph; without them every weight counts 1 and wsum is the
    degree).

    ``nbr`` (i32 [V, Dmax], pad -1): dense membership, a search in prev's
    resident row gathered once a step; None: a binary search in the CSR a
    candidate (`csr_contains`). ``uniform_rows`` (unweighted graphs, with
    nbr): a proposal is a uniform slot of cur's resident row in place of
    the alias draw.

    The batch and the number of rounds are `rejection_budget`'s, a fixed
    count; a walker already done draws on and is masked out. The uniforms
    come from `generator` or `draws` (`rejection_draw_shapes`).
    """
    if envelope is None:
        envelope = wsum is not None
    row_slots = bool(uniform_rows and nbr is not None)
    n_prop, max_tries = rejection_budget(p, q, envelope=envelope)
    n_rounds = -(-max_tries // n_prop)
    a_coef, beta, acc_prev, acc_shared, acc_other = rejection_constants(
        p, q, envelope=envelope)
    device = starts.device
    col = _nonempty(col_idx, -1)
    last = col.shape[0] - 1
    accept, alias = _nonempty(accept, 1.0), _nonempty(alias, 0)
    deg_all = degree.to(torch.int64)
    if wsum is None:
        wsum = degree.to(torch.float32)
    if edge_weight is not None:
        edge_weight = _nonempty(edge_weight, 0.0)

    cur = starts.to(torch.int64)
    B = cur.shape[0]
    rand = Uniforms(generator, draws, rejection_draw_shapes(
        B, length, p, q, envelope=envelope, row_slots=row_slots), device)
    out = _first_column(cur, length)
    if length > 1:
        # first hop: a plain weighted draw
        deg = deg_all[cur]
        rp = row_ptr[cur]
        slot = alias_draw(accept, alias, rp, deg.clamp(min=1), rand(B),
                          rand(B))
        nxt = col[(rp + slot).clamp(max=last)].to(torch.int64)
        prev, cur = cur, torch.where(deg > 0, nxt, -1)
        out[:, 1] = cur.to(torch.int32)
    for t in range(2, length):
        safe, psafe = _safe(cur), _safe(prev)
        deg = torch.where(cur >= 0, deg_all[safe], 0)
        offs = row_ptr[safe][:, None].expand(B, n_prop)
        degb = deg.clamp(min=1)[:, None].expand(B, n_prop)
        prevb = psafe[:, None].expand(B, n_prop)
        if envelope:
            # the prev point's mass: a = a_coef * w(cur -> prev), 0 where
            # the edge is absent (directed graphs); one csr_find a walker
            pfound, ppos = csr_find(row_ptr, col, degree, safe, psafe,
                                    max_degree=max_degree)
            pfound = pfound & (prev >= 0)
            if edge_weight is None:
                w_prev = pfound.to(torch.float32)
            else:
                w_prev = torch.where(
                    pfound,
                    edge_weight[ppos.clamp(max=edge_weight.shape[0] - 1)],
                    0.0)
            a = a_coef * w_prev
            p_point = a / (a + beta * wsum[safe]).clamp(min=1e-30)
        srt_prev = sorted_rows(nbr[psafe]) if nbr is not None else None
        nbr_cur = nbr[safe] if row_slots else None
        done = torch.zeros(B, dtype=torch.bool, device=device)
        y = torch.zeros(B, dtype=col.dtype, device=device)
        for _ in range(n_rounds):
            u1 = rand((B, n_prop))
            if nbr_cur is not None:
                slot = torch.minimum(
                    (u1 * degb.to(torch.float32)).to(torch.int64), degb - 1)
                cand = nbr_cur.gather(1, slot)
            else:
                slot = alias_draw(accept, alias, offs, degb, u1,
                                  rand((B, n_prop)))
                cand = col[(offs + slot).clamp(max=last)]
            if envelope:
                take_point = rand((B, n_prop)) < p_point[:, None]
                cand = torch.where(take_point, prevb.to(cand.dtype), cand)
            is_prev = cand == prev[:, None]
            if srt_prev is not None:
                in_prev = rows_contain(srt_prev, cand)
            else:
                in_prev = csr_contains(row_ptr, col, degree, prevb, cand,
                                       max_degree=max_degree)
            ratio = torch.where(is_prev, acc_prev,
                                torch.where(in_prev, acc_shared, acc_other))
            acc = rand((B, n_prop)) < ratio
            # the first accepted proposal; none accepted: the last one
            any_acc = acc.any(dim=1)
            first = acc.to(torch.uint8).argmax(dim=1)
            pick = torch.where(any_acc, first, n_prop - 1)
            y = torch.where(done, y, cand.gather(1, pick[:, None])[:, 0])
            done = done | any_acc
        prev, cur = cur, torch.where(deg > 0, y.to(torch.int64), -1)
        out[:, t] = cur.to(torch.int32)
    return out


# --------------------------------------------------------------------------- #
# the kernels (csrc/walk.cu): a corpus a launch
# --------------------------------------------------------------------------- #


def on_card(name, *tensors):
    """True where every tensor lies on one CUDA device, False where all lie
    on the CPU (the plain version's case); raises on any other mix."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices: "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev.type == "cuda"


def check_tensor(name, what, t, dtype, dim):
    """Raise unless `t` is a contiguous `dtype` tensor of `dim` dims."""
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(
            f"{name}: {what} must be a contiguous {dtype} tensor of {dim} "
            f"dims, got {t.dtype} {tuple(t.shape)}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def walk_starts(name, starts):
    """`starts` as the kernels read them: contiguous int64 [B]."""
    if starts.dim() != 1 or starts.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name}: starts must be int32 or int64 [B], got "
                         f"{starts.dtype} {tuple(starts.shape)}")
    return starts.to(torch.int64).contiguous()


def kernel_rng(name, generator, draws, shapes, device):
    """(draws pointer or None, seed tensor) of a launch: the shared draws,
    or the Philox key, one 62-bit integer drawn from `generator` into a
    device tensor (no host sync); exactly one of the two may be given. A
    walk that draws nothing (length 1) gets a zero key."""
    if (generator is None) == (draws is None):
        raise ValueError(f"{name}: pass exactly one of generator= and "
                         f"draws=")
    if draws is None:
        return None, torch.randint(0, 1 << 62, (1,), dtype=torch.int64,
                                   generator=generator, device=device)
    check_draws(draws, shapes, device, name)
    if draws.numel() == 0:
        return None, torch.zeros(1, dtype=torch.int64, device=device)
    return draws.data_ptr(), None


def ptr_or_null(t):
    return None if t is None else t.data_ptr()


def _first_order(name, row_ptr, col_idx, degree, accept, alias, starts,
                 length, generator, draws):
    """K6: first-order walks, uniform (accept is None) or by alias."""
    check_tensor(name, "row_ptr", row_ptr, torch.int64, 1)
    check_tensor(name, "col_idx", col_idx, torch.int32, 1)
    check_tensor(name, "degree", degree, torch.int32, 1)
    V, E = degree.shape[0], col_idx.shape[0]
    if row_ptr.shape[0] != V + 1:
        raise ValueError(f"{name}: row_ptr must be [V + 1] = [{V + 1}], got "
                         f"{tuple(row_ptr.shape)}")
    shapes = uniform_draw_shapes
    if accept is not None:
        check_tensor(name, "accept", accept, torch.float32, 1)
        check_tensor(name, "alias", alias, torch.int32, 1)
        if accept.shape[0] != E or alias.shape[0] != E:
            raise ValueError(f"{name}: accept and alias must be [E] = [{E}]")
        shapes = weighted_draw_shapes
    starts = walk_starts(name, starts)
    B, dev = starts.shape[0], starts.device
    draws_ptr, seed = kernel_rng(name, generator, draws, shapes(B, length),
                                 dev)
    out = torch.empty((B, length), dtype=torch.int32, device=dev)
    if B == 0 or length == 0:
        return out
    kb.check(kb.library().ge_walk_first_order(
        dev.index, row_ptr.data_ptr(), col_idx.data_ptr(), degree.data_ptr(),
        ptr_or_null(accept), ptr_or_null(alias), E, starts.data_ptr(), B,
        length, draws_ptr, ptr_or_null(seed), out.data_ptr(),
        kb.stream_ptr(dev)), name)
    (uniform_walks if accept is None else weighted_walks).launches += 1
    return out


def uniform_walks(row_ptr, col_idx, degree, starts, *, length,
                  generator=None, draws=None):
    """K6: DeepWalk walks from `starts` (int [B]), uniform next hop, int32
    [B, length]; -1 from a node without out-edges on.

    row_ptr int64 [V+1], col_idx int32 [E], degree int32 [V]. On a card,
    one launch of `csrc/walk.cu`'s first-order walk: its uniforms from
    Philox keyed by a seed drawn from `generator`, or the shared `draws`
    (`uniform_draw_shapes`; then equal to `uniform_walks_plain` on the same
    draws). On the CPU, `uniform_walks_plain`.
    """
    if not on_card("uniform_walks", row_ptr, col_idx, degree, starts):
        return uniform_walks_plain(row_ptr, col_idx, degree, starts,
                                   length=length, generator=generator,
                                   draws=draws)
    return _first_order("uniform_walks", row_ptr, col_idx, degree, None,
                        None, starts, length, generator, draws)


uniform_walks.launches = 0


def weighted_walks(row_ptr, col_idx, degree, accept, alias, starts, *,
                   length, generator=None, draws=None):
    """K6 by alias: first-order weighted walks, one alias draw a hop from
    the per-row tables (`accept` f32 [E], `alias` i32 [E], aligned to the
    CSR). On a card one launch (Philox from `generator`, or `draws` by
    `weighted_draw_shapes`); on the CPU `weighted_walks_plain`."""
    if not on_card("weighted_walks", row_ptr, col_idx, degree, accept,
                   alias, starts):
        return weighted_walks_plain(row_ptr, col_idx, degree, accept, alias,
                                    starts, length=length,
                                    generator=generator, draws=draws)
    return _first_order("weighted_walks", row_ptr, col_idx, degree, accept,
                        alias, starts, length, generator, draws)


weighted_walks.launches = 0


def node2vec_walks(degree, nbr, nbr_w, starts, p, q, *, length,
                   generator=None, draws=None):
    """K7: the exact (p,q) walk of `node2vec_walks_plain` (which the CPU
    runs). On a card one launch of `csrc/walk.cu`'s exact walk, a warp a
    walker over cur's padded row: the same scores and the same argmax
    (ties to the first column), from Philox keyed by a seed drawn from
    `generator` or from the shared `draws` (`node2vec_draw_shapes`)."""
    name = "node2vec_walks"
    if not on_card(name, degree, nbr, nbr_w, starts):
        return node2vec_walks_plain(degree, nbr, nbr_w, starts, p, q,
                                    length=length, generator=generator,
                                    draws=draws)
    check_tensor(name, "degree", degree, torch.int32, 1)
    check_tensor(name, "nbr", nbr, torch.int32, 2)
    check_tensor(name, "nbr_w", nbr_w, torch.float32, 2)
    V, D = nbr.shape
    if tuple(nbr_w.shape) != (V, D) or degree.shape[0] != V or D < 1:
        raise ValueError(f"{name}: nbr and nbr_w must be [V, D] with D >= 1 "
                         f"and degree [V]")
    starts = walk_starts(name, starts)
    B, dev = starts.shape[0], starts.device
    draws_ptr, seed = kernel_rng(name, generator, draws,
                                 node2vec_draw_shapes(B, length, D), dev)
    out = torch.empty((B, length), dtype=torch.int32, device=dev)
    if B == 0 or length == 0:
        return out
    kb.check(kb.library().ge_walk_exact_pq(
        dev.index, degree.data_ptr(), nbr.data_ptr(), nbr_w.data_ptr(), D,
        starts.data_ptr(), B, length, 1.0 / float(p), 1.0 / float(q),
        draws_ptr, ptr_or_null(seed), out.data_ptr(), kb.stream_ptr(dev)),
        name)
    node2vec_walks.launches += 1
    return out


node2vec_walks.launches = 0

# flags of csrc/walk.cu's rejection walk
_ENVELOPE, _DENSE, _ROW_SLOTS = 1, 2, 4


def node2vec_walks_rejection(row_ptr, col_idx, degree, accept, alias,
                             starts, p, q, *, length, max_degree,
                             generator=None, draws=None, edge_weight=None,
                             wsum=None, envelope=None, nbr=None,
                             uniform_rows=False):
    """K8: the rejection (p,q) walk of `node2vec_walks_rejection_plain`
    (which the CPU runs; its arguments and forms). On a card one launch of
    `csrc/walk.cu`'s rejection walk, a thread a walker: the same proposals,
    membership tests and acceptances, the same budget of rounds, a walker
    stopping at its first accepted proposal; from Philox keyed by a seed
    drawn from `generator` or the shared `draws`
    (`rejection_draw_shapes`)."""
    name = "node2vec_walks_rejection"
    if not on_card(name, row_ptr, col_idx, degree, accept, alias, starts,
                   edge_weight, wsum, nbr):
        return node2vec_walks_rejection_plain(
            row_ptr, col_idx, degree, accept, alias, starts, p, q,
            length=length, max_degree=max_degree, generator=generator,
            draws=draws, edge_weight=edge_weight, wsum=wsum,
            envelope=envelope, nbr=nbr, uniform_rows=uniform_rows)
    if envelope is None:
        envelope = wsum is not None
    row_slots = bool(uniform_rows and nbr is not None)
    check_tensor(name, "row_ptr", row_ptr, torch.int64, 1)
    check_tensor(name, "col_idx", col_idx, torch.int32, 1)
    check_tensor(name, "degree", degree, torch.int32, 1)
    check_tensor(name, "accept", accept, torch.float32, 1)
    check_tensor(name, "alias", alias, torch.int32, 1)
    V, E = degree.shape[0], col_idx.shape[0]
    if (row_ptr.shape[0] != V + 1 or accept.shape[0] != E
            or alias.shape[0] != E):
        raise ValueError(f"{name}: row_ptr must be [V + 1], accept and alias "
                         f"[E]")
    if edge_weight is not None:
        check_tensor(name, "edge_weight", edge_weight, torch.float32, 1)
        if edge_weight.shape[0] != E:
            raise ValueError(f"{name}: edge_weight must be [E] = [{E}]")
    if wsum is None:
        wsum = degree.to(torch.float32)
    check_tensor(name, "wsum", wsum, torch.float32, 1)
    D = 0
    if nbr is not None:
        check_tensor(name, "nbr", nbr, torch.int32, 2)
        D = nbr.shape[1]
        if nbr.shape[0] != V or D < 1:
            raise ValueError(f"{name}: nbr must be [V, D] with D >= 1")
    if wsum.shape[0] != V:
        raise ValueError(f"{name}: wsum must be [V] = [{V}]")
    starts = walk_starts(name, starts)
    B, dev = starts.shape[0], starts.device
    n_prop, max_tries = rejection_budget(p, q, envelope=envelope)
    a_coef, beta, acc_prev, acc_shared, acc_other = rejection_constants(
        p, q, envelope=envelope)
    shapes = rejection_draw_shapes(B, length, p, q, envelope=envelope,
                                   row_slots=row_slots)
    draws_ptr, seed = kernel_rng(name, generator, draws, shapes, dev)
    out = torch.empty((B, length), dtype=torch.int32, device=dev)
    if B == 0 or length == 0:
        return out
    flags = (_ENVELOPE * bool(envelope) + _DENSE * (nbr is not None)
             + _ROW_SLOTS * row_slots)
    kb.check(kb.library().ge_walk_rejection_pq(
        dev.index, row_ptr.data_ptr(), col_idx.data_ptr(), degree.data_ptr(),
        accept.data_ptr(), alias.data_ptr(), E, ptr_or_null(edge_weight),
        wsum.data_ptr(), ptr_or_null(nbr), D, starts.data_ptr(), B, length,
        n_prop, -(-max_tries // n_prop), flags, a_coef, beta, acc_prev,
        acc_shared, acc_other, draws_ptr, ptr_or_null(seed), out.data_ptr(),
        kb.stream_ptr(dev)), name)
    node2vec_walks_rejection.launches += 1
    return out


node2vec_walks_rejection.launches = 0


def walk_kernels():
    """The wrappers of the walk kernels of this module (K6-K8) by name."""
    return {k.__name__: k for k in (uniform_walks, weighted_walks,
                                    node2vec_walks,
                                    node2vec_walks_rejection)}


# --------------------------------------------------------------------------- #
# the corpus
# --------------------------------------------------------------------------- #


def select_pq_kernel(num_nodes, max_degree,
                     hbm_budget_bytes=PQ_BUDGET_BYTES) -> str:
    """The (p,q) sampler for a graph: 'exact', 'rejection_dense' or
    'rejection' (CSR membership).

    The JAX package's rule, kept as it is so that both packages pick the
    same sampler on the same graph: exact while the neighbor axis, padded
    to 128 lanes, is at most 384 and the [V, Dpad] ids and weights (8
    bytes a slot) fit the budget; else dense-membership rejection while
    the ids alone (4 bytes a slot) fit; else CSR rejection. The 128-lane
    padding, the 384 crossover and the 4 GiB default budget are
    measurements and rules of a TPU v5e (the JAX package's
    `pq_crossover_r05`), not of the H100; the port's own crossover is not
    measured yet. A mesh passes the budget times its data-axis size, as
    its rows are spread over the ranks. (The JAX signature's p and q do
    not enter its rule, and are not taken.)
    """
    dpad = ((max(max_degree, 1) + _LANE - 1) // _LANE) * _LANE
    if dpad <= 384 and num_nodes * dpad * 8 <= hbm_budget_bytes:
        return "exact"
    if num_nodes * dpad * 4 <= hbm_budget_bytes:
        return "rejection_dense"
    return "rejection"


def pq_sampler(num_nodes, max_degree, use_rejection_sampling=None,
               hbm_budget_bytes=PQ_BUDGET_BYTES):
    """The (p,q) sampler of a graph under the reference's flag: by
    `select_pq_kernel` for None; 'exact' for False; for True, rejection
    with its membership mode chosen by the same memory budget."""
    choice = select_pq_kernel(num_nodes, max_degree, hbm_budget_bytes)
    if use_rejection_sampling is None:
        return choice
    if not use_rejection_sampling:
        return "exact"
    # exact fits the budget at 8 bytes a slot, so the ids fit at 4
    return "rejection_dense" if choice == "exact" else choice


def simulate_walks(graph, num_walks: int, walk_length: int, *, generator,
                   kind: str = "uniform", p: float = 1.0, q: float = 1.0,
                   sampler=None):
    """The walk corpus [num_walks * V, walk_length] (int32): every vertex
    starts `num_walks` walks (`arange(V)` tiled `num_walks` times).

    `graph` is a host `Graph`, walked on the generator's device with its
    views there (each built once). kind: 'uniform', 'weighted' (alias
    tables) or 'node2vec' with `p`, `q` and a `sampler`: 'exact',
    'rejection_dense', 'rejection' (CSR membership), or None for
    `select_pq_kernel`'s choice (`pq_sampler` maps the reference's
    `use_rejection_sampling` flag to one).
    """
    device = generator.device
    dg = graph.to(device)
    starts = torch.arange(dg.num_nodes, dtype=torch.int64,
                          device=device).repeat(num_walks)
    if kind == "uniform":
        return uniform_walks(dg.row_ptr, dg.col_idx, dg.degree, starts,
                             length=walk_length, generator=generator)
    if kind == "weighted":
        accept, alias = graph.alias_tables(device)
        return weighted_walks(dg.row_ptr, dg.col_idx, dg.degree, accept,
                              alias, starts, length=walk_length,
                              generator=generator)
    if kind != "node2vec":
        raise ValueError(f"unknown walk kind: {kind!r}")
    if sampler is None:
        sampler = select_pq_kernel(dg.num_nodes, dg.max_degree)
    if sampler == "exact":
        nbr, nbr_w = graph.neighbor_matrix(device)
        return node2vec_walks(dg.degree, nbr, nbr_w, starts, p, q,
                              length=walk_length, generator=generator)
    if sampler not in ("rejection", "rejection_dense"):
        raise ValueError(f"unknown (p,q) sampler: {sampler!r}")
    accept, alias = graph.alias_tables(device)
    # ids only: the weights would double the footprint the budget gates
    nbr = graph.neighbor_ids(device) if sampler == "rejection_dense" else None
    # an unweighted graph with resident rows draws slots, not alias pairs
    return node2vec_walks_rejection(
        dg.row_ptr, dg.col_idx, dg.degree, accept, alias, starts, p, q,
        length=walk_length, max_degree=max(dg.max_degree, 1),
        generator=generator, edge_weight=dg.edge_weight,
        wsum=graph.weight_sums(device), nbr=nbr,
        uniform_rows=nbr is not None and graph.unit_weights)
