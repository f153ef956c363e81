"""LINE (Tang et al., WWW'15): first- and second-order proximity embeddings.

Counterpart of `graphembedding_tpu/models/line.py` (the sampled trainer).
Each step samples B edges by weight (an alias table over the edges) and
negatives from a degree^0.75 table, gathers the rows it scores (K3), takes
one positive pair and its negatives per edge, and scatter-adds the
updates, one call per table (`ops.rows.scatter_add_table`: K4 while the
table has at most SMALL_V_ROWS rows, K2 above). All gathers of a step come
before its scatters, so one call on the concatenated ids equals the JAX
step's sequential `.at[].add` calls up to the order of the sums within one
XLA scatter.

Orders: 'first' trains `first_emb` with symmetric dots (no context table);
'second' trains `second_emb` against `context_emb`; 'all' trains both and
concatenates them.

The draws of a chunk of steps come from a `torch.Generator` on the
model's device (`line_bulk_samples`), and `line_steps` takes them as
inputs, so a test can hand it the JAX package's draws. The generators'
streams differ from JAX's, so whole trainings agree in distribution and
micro-F1 band, not in value.

`trainer='dense'` optimizes LINE's EXPECTED objective in closed form
(`train.dense.dense_fit`): the positive-pair expectation of edge sampling
is the weighted adjacency (duplicate edges summed), the negatives the
rank-1 wdeg^0.75 expectation; order 'first' trains one tied table, order
'second' an untied pair. Its initial tables come from CPU generators, one
stream an order, as the sampled trainer's draws do.

The sampled trainer checkpoints and resumes each order in a subdirectory
of `checkpoint_dir` (`line_train`), bit-identical to an uninterrupted run.

Not ported: `mesh=` and `sync_every=`; each raises NotImplementedError with
the sampled trainer (the dense one ignores them, as in the JAX package).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from graphembedding_tpu_torch.models.base import as_graph, model_device
from graphembedding_tpu_torch.ops.alias import build_alias_table
from graphembedding_tpu_torch.ops.rows import ROW_KERNELS, ROW_PLAIN
from graphembedding_tpu_torch.ops.spmm import adjacency
from graphembedding_tpu_torch.train.dense import (
    DenseSGNSConfig,
    dense_fit,
    initial_table,
)
from graphembedding_tpu_torch.train.skipgram import inverse_cdf_table
from graphembedding_tpu_torch.utils.checkpoint import maybe_save, try_restore

# steps a chunk of draws covers; a run is whole chunks, as in the JAX package
CHUNK_STEPS = 512
# what a checkpoint of `line_train` holds
LINE_STATE_KEYS = ("emb", "ctx", "chunk", "rng")


# the row kernels a step runs (gather, scatter-add), and their plain
# versions, which the kernels are held against
KERNELS, PLAIN = ROW_KERNELS, ROW_PLAIN


def _neg_grouping(batch_size, negative, k_shared):
    """Pairs per shared negative set (NG) and groups per step (Bg)."""
    B, K, K2 = batch_size, negative, k_shared
    NG = max(min(K2 // max(K, 1), B), 1)
    while B % NG:
        NG -= 1
    return NG, B // NG


def line_bulk_samples(edge_src, edge_dst, edge_accept, edge_alias,
                      neg_table, generator, lr0, t0, total_steps, *,
                      chunk_steps, batch_size, negative, k_shared):
    """The draws of one chunk, on the edges' device: B edges a step by
    weight (alias draw), negatives from the degree^0.75 table ([S, B, K];
    [S, Bg, k_shared] when shared), and the linear-decay learning rates
    lr0 * max(1 - (t0 + s) / total_steps, 1e-4) in float32. Returns
    (hs [S, B], tposs [S, B], tnegs, lrs [S])."""
    dev = edge_src.device
    n_edges = edge_src.shape[0]
    S, B = chunk_steps, batch_size
    u1 = torch.rand((S, B), generator=generator, device=dev)
    u2 = torch.rand((S, B), generator=generator, device=dev)
    pick = (u1 * n_edges).to(torch.int64).clamp(max=n_edges - 1)
    eidx = torch.where(u2 < edge_accept[pick], pick, edge_alias[pick])
    if k_shared:
        neg_shape = (S, _neg_grouping(B, negative, k_shared)[1], k_shared)
    else:
        neg_shape = (S, B, negative)
    tnegs = neg_table[torch.randint(0, neg_table.shape[0], neg_shape,
                                    generator=generator, device=dev)]
    steps = (t0 + torch.arange(S, device=dev)).to(torch.float32)
    lrs = (1.0 - steps / total_steps).clamp(min=1e-4) * float(
        np.float32(lr0))
    return edge_src[eidx], edge_dst[eidx], tnegs, lrs


def line_step(emb, ctx, h, tpos, tneg, lr, *, negative, k_shared=0,
              update_cap=8.0, ops=KERNELS):
    """One LINE step on B sampled edges; updates the tables in place.

    emb [V, D] is the trained table; ctx [V, D] the context table, or None
    for order 'first' (positives and negatives then come from emb, and no
    context table is touched). h, tpos [B] int32 edge ends; tneg [B, K]
    int32 per-pair negatives, or [Bg, k_shared] sets shared by groups of
    NG consecutive pairs (each event weighted negative / k_shared, the
    shared rows' update capped at `update_cap` event weights); lr a
    float32 scalar. Returns the loss as a 0-d tensor.
    """
    B, D = h.shape[0], emb.shape[1]
    tneg_flat = tneg.reshape(-1)
    tgt = torch.cat([tpos, tneg_flat])
    if ctx is None:
        ids = torch.cat([h, tgt])
        rows = ops.gather(emb, ids)
        u, v, vn = rows[:B], rows[B:2 * B], rows[2 * B:]
    else:
        u = ops.gather(emb, h)
        rows = ops.gather(ctx, tgt)
        v, vn = rows[:B], rows[B:]
    vn = vn.view(*tneg.shape, D)

    pos_logit = (u * v).sum(-1)
    g_pos = torch.sigmoid(pos_logit) - 1.0
    d_v = g_pos[:, None] * u
    if k_shared:
        NG, Bg = _neg_grouping(B, negative, k_shared)
        ug = u.view(Bg, NG, D)
        neg_logit = torch.einsum("gbd,gkd->gbk", ug, vn)
        w = np.float32(negative) / np.float32(k_shared)
        g_neg = torch.sigmoid(neg_logit) * float(w)
        d_u = g_pos[:, None] * v + torch.einsum(
            "gbk,gkd->gbd", g_neg, vn).reshape(B, D)
        # the per-row accumulated event weight is NG * w (about 1 by
        # construction); the cap only guards the tail
        scale = min(np.float32(1.0), np.float32(update_cap)
                    / max(np.float32(NG) * w, np.float32(1.0)))
        d_vn = torch.einsum("gbk,gbd->gkd", g_neg, ug) * float(scale)
        neg_loss = (float(w) * F.logsigmoid(-neg_logit).sum(2)).reshape(B)
    else:
        neg_logit = torch.einsum("bd,bkd->bk", u, vn)
        g_neg = torch.sigmoid(neg_logit)
        d_u = g_pos[:, None] * v + torch.einsum("bk,bkd->bd", g_neg, vn)
        d_vn = g_neg[:, :, None] * u[:, None, :]
        neg_loss = F.logsigmoid(-neg_logit).sum(-1)

    d_tgt = torch.cat([d_v, d_vn.reshape(-1, D)])
    if ctx is None:
        ops.scatter_add(emb, ids, torch.cat([d_u, d_tgt]) * (-lr))
    else:
        ops.scatter_add(emb, h, d_u * (-lr))
        ops.scatter_add(ctx, tgt, d_tgt * (-lr))
    return -(F.logsigmoid(pos_logit).mean() + neg_loss.mean())


def line_steps(emb, ctx, hs, tposs, tnegs, lrs, *, negative, k_shared=0,
               update_cap=8.0, ops=KERNELS):
    """S = hs.shape[0] steps on given draws (the JAX chunk's scan).
    Returns (emb, ctx, losses [S]); the tables are updated in place."""
    losses = [line_step(emb, ctx, hs[s], tposs[s], tnegs[s], lrs[s],
                        negative=negative, k_shared=k_shared,
                        update_cap=update_cap, ops=ops)
              for s in range(hs.shape[0])]
    return emb, ctx, torch.stack(losses)


def line_train_chunk(emb, ctx, edge_src, edge_dst, edge_accept, edge_alias,
                     neg_table, generator, lr0, t0, total_steps, *,
                     chunk_steps, batch_size, negative, k_shared=0,
                     update_cap=8.0, ops=KERNELS):
    """One chunk: its draws (`line_bulk_samples`), then its steps."""
    hs, tposs, tnegs, lrs = line_bulk_samples(
        edge_src, edge_dst, edge_accept, edge_alias, neg_table, generator,
        lr0, t0, total_steps, chunk_steps=chunk_steps,
        batch_size=batch_size, negative=negative, k_shared=k_shared)
    return line_steps(emb, ctx, hs, tposs, tnegs, lrs, negative=negative,
                      k_shared=k_shared, update_cap=update_cap, ops=ops)


def line_train(emb, ctx, edge_src, edge_dst, edge_accept, edge_alias,
               neg_table, generator, lr0, *, n_steps, batch_size, negative,
               k_shared=0, update_cap=8.0, ops=KERNELS, checkpoint_dir=None,
               checkpoint_every=0):
    """A full run as ceil(n_steps / CHUNK_STEPS) whole chunks, as the JAX
    package runs it: steps past n_steps train at the floor learning rate
    lr0 * 1e-4. Returns (emb, ctx, losses [CHUNK_STEPS * chunks this call
    ran]).

    checkpoint_dir / checkpoint_every: save (emb, ctx, chunk) and the
    generator's state after every `checkpoint_every`-th chunk of the run,
    and resume from the checkpoint in `checkpoint_dir` when there is one,
    with the chunks it already holds skipped: a resumed run equals an
    uninterrupted one bit for bit. Order 'first' has no context table, and
    its checkpoint holds ctx None (the JAX package's holds a [1, D]
    placeholder).
    """
    n_chunks = max((n_steps + CHUNK_STEPS - 1) // CHUNK_STEPS, 1)
    resume_chunk = 0
    state = (try_restore(checkpoint_dir, LINE_STATE_KEYS)
             if checkpoint_dir else None)
    if state is not None:
        emb = state["emb"].to(emb.device)
        ctx = None if state["ctx"] is None else state["ctx"].to(emb.device)
        generator.set_state(state["rng"])
        resume_chunk = int(state["chunk"])
    losses = []
    for c in range(resume_chunk, n_chunks):
        emb, ctx, lc = line_train_chunk(
            emb, ctx, edge_src, edge_dst, edge_accept, edge_alias,
            neg_table, generator, lr0, c * CHUNK_STEPS, float(n_steps),
            chunk_steps=CHUNK_STEPS, batch_size=batch_size,
            negative=negative, k_shared=k_shared, update_cap=update_cap,
            ops=ops)
        losses.append(lc)
        maybe_save(checkpoint_dir, checkpoint_every, c + 1,
                   lambda: {"emb": emb, "ctx": ctx, "chunk": c + 1,
                            "rng": generator.get_state()})
    if not losses:  # fully resumed past the end
        return emb, ctx, torch.zeros(0, device=emb.device)
    return emb, ctx, torch.cat(losses)


def dense_line_inputs(graph, device):
    """(A [V, V], q [V]) of LINE's closed-form objective: the weighted
    adjacency with duplicate edges summed (from the coalesced CSR, so the
    same bits on every run) and q = wdeg^0.75."""
    A = adjacency(graph, device=device).to_dense()
    return A, A.sum(1).clamp(min=0.0).pow(0.75)


class LINE:
    def __init__(self, graph, embedding_size=8, negative_ratio=5,
                 order="second", seed=0, k_shared=0, update_cap=8.0,
                 device="cuda"):
        if order not in ("first", "second", "all"):
            raise ValueError("order must be first / second / all")
        self.device = model_device(device)
        self.graph = as_graph(graph)
        self.embedding_size = embedding_size
        self.negative_ratio = negative_ratio
        self.order = order
        self.seed = seed
        self.k_shared = k_shared
        self.update_cap = update_cap
        self.losses = None
        self.sampled_edges = 0  # edges sampled by the last train()
        self._embeddings: Optional[Dict] = None

        g, dev = self.graph, self.device
        src, dst, w = g.edges()
        self._edge_src = torch.as_tensor(src.astype(np.int32), device=dev)
        self._edge_dst = torch.as_tensor(dst.astype(np.int32), device=dev)
        # edge alias table by weight (the reference's `_gen_sampling_table`)
        acc, alias = build_alias_table(w.astype(np.float64))
        self._edge_accept = torch.as_tensor(acc, device=dev)
        self._edge_alias = torch.as_tensor(alias.astype(np.int64), device=dev)
        # negatives by weighted out-degree^0.75, as a 2^20-slot table
        wdeg = np.zeros(g.num_nodes, dtype=np.float64)
        np.add.at(wdeg, src, w.astype(np.float64))
        self._neg_table = inverse_cdf_table(torch.as_tensor(
            np.power(wdeg, 0.75).astype(np.float32), device=dev), 1 << 20)

        gen = torch.Generator(device=dev).manual_seed(seed)
        V, D = g.num_nodes, embedding_size

        def uniform():  # U[-1/D, 1/D)
            return (torch.rand((V, D), generator=gen, device=dev) * 2.0
                    - 1.0) / D

        self.first_emb = uniform()
        self.second_emb = uniform()
        self.context_emb = uniform()

    def train(self, batch_size=1024, epochs=1, initial_lr=0.025, verbose=0,
              times=1, checkpoint_dir=None, checkpoint_every=0, mesh=None,
              sync_every=None, trainer="sampled", steps=300, lr=0.1):
        """The reference signature. The sampled trainer runs
        round(epochs * times * E / batch_size) steps per order, as whole
        chunks of CHUNK_STEPS, with checkpoint_dir / checkpoint_every
        (`line_train`) in one subdirectory an order, 'first' and 'second';
        trainer='dense' runs `steps` Adam steps at `lr` on the closed-form
        objective."""
        del verbose
        if trainer == "dense":
            return self._train_dense(steps=steps, lr=lr)
        if trainer != "sampled":
            raise ValueError(f"unknown trainer {trainer!r}")
        for name, value in (("mesh", mesh), ("sync_every", sync_every)):
            if value is not None:
                raise NotImplementedError(
                    f"{name}= is not ported to graphembedding_tpu_torch")
        g = self.graph
        n_steps = max(int(round(epochs * times * g.num_edges / batch_size)),
                      1)
        kw = dict(n_steps=n_steps, batch_size=batch_size,
                  negative=self.negative_ratio,
                  k_shared=min(self.k_shared, g.num_nodes),
                  update_cap=self.update_cap,
                  checkpoint_every=checkpoint_every)
        edges = (self._edge_src, self._edge_dst, self._edge_accept,
                 self._edge_alias, self._neg_table)

        def order_dir(order):
            return (os.path.join(checkpoint_dir, order) if checkpoint_dir
                    else None)

        self.sampled_edges = 0
        # each order draws from a stream of its own, as the JAX package
        # folds the order into its key
        if self.order in ("first", "all"):
            self.first_emb, _, self.losses = line_train(
                self.first_emb, None, *edges, self._generator(0), initial_lr,
                checkpoint_dir=order_dir("first"), **kw)
            self.sampled_edges += self.losses.shape[0] * batch_size
        if self.order in ("second", "all"):
            self.second_emb, self.context_emb, self.losses = line_train(
                self.second_emb, self.context_emb, *edges,
                self._generator(1), initial_lr,
                checkpoint_dir=order_dir("second"), **kw)
            self.sampled_edges += self.losses.shape[0] * batch_size
        self._embeddings = None
        return self

    def _train_dense(self, *, steps, lr):
        """The closed-form expected-LINE fit (see the module docstring)."""
        dcfg = DenseSGNSConfig(steps=steps, lr=lr, seed=self.seed)
        V, D = self.graph.num_nodes, self.embedding_size
        if V > dcfg.max_nodes:
            raise ValueError(f"trainer='dense' is for V <= {dcfg.max_nodes}; "
                             "use the sampled trainer at scale")
        A, q = dense_line_inputs(self.graph, self.device)

        def fit(stream, tied):
            U0 = initial_table(V, D, 2 * (self.seed + 1) + stream,
                               self.device)
            return dense_fit(A, U0, self.negative_ratio, dcfg.ns_exponent,
                             dcfg.lr, dcfg.b1, dcfg.b2, dcfg.eps,
                             steps=dcfg.steps, q=q, tied=tied)

        losses = []
        if self.order in ("first", "all"):
            self.first_emb, _, l1 = fit(0, True)
            losses.append(l1)
        if self.order in ("second", "all"):
            self.second_emb, self.context_emb, l2 = fit(1, False)
            losses.append(l2)
        self.losses = torch.cat(losses)
        self.sampled_edges = 0
        self._embeddings = None
        return self

    def _generator(self, stream):
        return torch.Generator(device=self.device).manual_seed(
            2 * (self.seed + 1) + stream)

    @property
    def embedding_table(self) -> torch.Tensor:
        """The [V, D] table get_embeddings reads ([V, 2D] for 'all')."""
        if self.order == "first":
            return self.first_emb
        if self.order == "second":
            return self.second_emb
        return torch.cat([self.first_emb, self.second_emb], 1)

    def get_embeddings(self) -> Dict:
        """{node_name: np.ndarray}, the reference's type."""
        if self._embeddings is None:
            table = self.embedding_table.detach().cpu().numpy()
            names = self.graph.vocab.idx2node
            self._embeddings = {names[i]: table[i]
                                for i in range(self.graph.num_nodes)}
        return self._embeddings
