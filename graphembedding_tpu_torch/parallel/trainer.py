"""The walk-block SGNS fit over a mesh: `DistributedSkipGramTrainer`.

Counterpart of `graphembedding_tpu/parallel/trainer.py`, reached from the
models by `train(mesh=m, parallel_mode=...)`:

    DeepWalk(G, ..., device="cuda").train(mesh=make_mesh((n, 1)))

in every rank's process. Two modes:

- 'rowshard' (the default): one global table, its rows split over the data
  axis, exact synchronous updates (`parallel/rowshard.py`);
- 'dp': table replicas over the data axis with their deltas summed every
  `dp_sync_every` steps, columns over the model axis (`parallel/sgns.py`).

Over NCCL each chunk of `chunk_steps` steps replays one CUDA graph (the
chunk functions' `train.chunk_graph.run_chunk`); over gloo with CUDA
tensors its steps run one by one. The draws, the checkpoints and their
bits are the same either way.

Both modes apply the dense cap whatever the config's `cap_mode`, as the
JAX package's mesh trainers do.

The block and its packing follow the JAX trainer: the block is the
single-device plan's (`train.skipgram.block_upscale`) capped at max(NW // 4,
n) and at (NW // n) * n walks, so every rank's slice holds real walks, and
the steps of an epoch count the walks the ranks actually train.

Two random streams, both `torch.Generator`s on the corpus' device: a shared
one, seeded with `seed`, draws the table, each epoch's shuffle and subsample
and (dp) the window draws, the same on every rank; a per-rank one, seeded
from (seed, data rank), draws what the JAX package folds by rank: the window
draws and negatives in rowshard, the negatives in dp. A checkpoint
(`utils.checkpoint.save_sharded`, a file a rank) holds this rank's table
part, the step, the shared stream's states at the save point and at the
epoch's start (`train.skipgram.Resume`) and the per-rank stream's state, so a
resumed fit equals an uninterrupted one bit for bit.
"""

from __future__ import annotations

import torch

from graphembedding_tpu_torch.parallel import comm
from graphembedding_tpu_torch.parallel.mesh import (
    check_mesh,
    put_global,
    rank_seed,
)
from graphembedding_tpu_torch.parallel.rowshard import (
    rank_geometry,
    rowsharded_sgns_chunk,
)
from graphembedding_tpu_torch.parallel.sgns import (
    dp_geometry,
    sharded_sgns_chunk,
)
from graphembedding_tpu_torch.train.skipgram import (
    Resume,
    SkipGramConfig,
    block_upscale,
    corpus_counts,
    keep_per_token,
    negative_table,
    prepare_epoch,
    window_draws,
)
from graphembedding_tpu_torch.utils.checkpoint import (
    maybe_save,
    save_sharded,
    try_restore_sharded,
)
from graphembedding_tpu_torch.utils.debug import (
    validate_walks,
    validation_enabled,
)

MODES = ("rowshard", "dp")


def mesh_block_walks(NW, num_nodes, cfg, n):
    """The block over n data ranks: the single-device plan capped at
    max(NW // 4, n) and (NW // n) * n walks."""
    if NW < n:
        raise ValueError(f"corpus has {NW} walks but the mesh data axis has "
                         f"{n} ranks; use a smaller mesh or more walks")
    return min(block_upscale(NW, num_nodes, cfg), max(NW // 4, n),
               (NW // n) * n)


def mesh_steps_per_epoch(NW, L, bw, n):
    """Steps of an epoch from the per-rank packing actually used."""
    per = max(bw // n, 1)
    pk = max(min(max(128 // L, 1), per), 1)
    return max(NW // (max((per // pk) * pk, pk) * n), 1)


class DistributedSkipGramTrainer:
    """`train.skipgram.SkipGramTrainer` over a `parallel.mesh.Mesh`."""

    def __init__(self, mesh, config: SkipGramConfig | None = None,
                 mode: str = "rowshard", **kw):
        if mode not in MODES:
            raise ValueError("mode must be 'rowshard' or 'dp'")
        self.mesh = check_mesh(mesh)
        self.mode = mode
        self.config = config or SkipGramConfig(**kw)
        self.trained_pairs_ = 0.0

    def fit(self, walks, num_nodes, seed=None, checkpoint_dir=None,
            checkpoint_every=0, metrics=None):
        """Train over the mesh on rank 0's corpus (int32 [NW, L], -1 pads).

        Returns (w_in [V, D], w_out [V, D], losses [steps this fit ran]),
        the full tables on every rank. checkpoint_dir / checkpoint_every /
        metrics as in `SkipGramTrainer.fit` (the metrics lines are
        `sgns_chunk_dist`), the checkpoint a file a rank.
        """
        cfg, mesh = self.config, self.mesh
        n, di = mesh.size("data"), mesh.get_local_rank("data")
        walks = put_global(walks, mesh)
        if validation_enabled():
            validate_walks(walks.cpu().numpy(), num_nodes)
        device = walks.device
        NW, L = walks.shape
        S = cfg.chunk_steps
        bw = mesh_block_walks(NW, num_nodes, cfg, n)
        rowshard = self.mode == "rowshard"
        geo = (rank_geometry if rowshard else dp_geometry)(
            NW, L, bw, n, cfg.neg_share_packs)
        chunks_per_epoch = max(
            (mesh_steps_per_epoch(NW, L, bw, n) + S - 1) // S, 1)
        total_steps = cfg.epochs * chunks_per_epoch * S
        k_shared = min(cfg.k_shared, num_nodes)
        counts = corpus_counts(walks, num_nodes)
        table = torch.as_tensor(
            negative_table(counts, cfg.ns_exponent, cfg.neg_table_size),
            device=device)
        keep_tok = keep_per_token(walks, counts, cfg.sample)

        seed = cfg.seed if seed is None else seed
        shared = torch.Generator(device=device).manual_seed(seed)
        ranked = torch.Generator(device=device).manual_seed(
            rank_seed(seed, di))
        D = cfg.embed_size
        w_in = (torch.rand((num_nodes, D), generator=shared, device=device)
                - 0.5) / D
        if rowshard:
            Vp = -(-num_nodes // n)
            w = torch.zeros((Vp, 2 * D), device=device)
            rows = w_in[di * Vp:(di + 1) * Vp]
            w[:rows.shape[0], :D] = rows
            parts = {"w_cat": slice(None)}
        else:
            m, mi = mesh.size("model"), mesh.get_local_rank("model")
            if D % m:
                raise ValueError(f"embed_size {D} does not split over the "
                                 f"model axis ({m})")
            Dl = D // m
            w = torch.cat([w_in[:, mi * Dl:(mi + 1) * Dl],
                           torch.zeros((num_nodes, Dl), device=device)], 1)
            parts = {"w_in": slice(0, Dl), "w_out": slice(Dl, 2 * Dl)}
        del w_in
        template = {k: w[:, c] for k, c in parts.items()}
        template.update(step=None, rng=None, rng_epoch=None, rng_rank=None)
        state = (try_restore_sharded(checkpoint_dir, template, mesh)
                 if checkpoint_dir else None)
        if state is not None:
            w = torch.cat([state[k] for k in parts], 1).to(device)
            ranked.set_state(state["rng_rank"])
        resume = Resume(state)

        losses, pairs = [], []
        t = 0
        n_chunk_calls = 0
        epoch_steps = chunks_per_epoch * S
        kw = dict(mesh=mesh, block_walks=bw, window=cfg.window,
                  negative=cfg.negative, neg_share_packs=cfg.neg_share_packs,
                  update_cap=cfg.update_cap)
        if rowshard:
            kw["prefetch"] = cfg.rowshard_prefetch
        else:
            kw["sync_every"] = cfg.dp_sync_every or None
        chunk = rowsharded_sgns_chunk if rowshard else sharded_sgns_chunk
        for epoch in range(cfg.epochs):
            if t + epoch_steps <= resume.step:
                t += epoch_steps  # a fully resumed epoch: no shuffle
                continue
            rng_epoch = resume.epoch_start(shared, t)
            shuffled = prepare_epoch(walks, keep_tok, shared)
            resume.chunks_start(shared)
            for _ in range(chunks_per_epoch):
                if t < resume.step:
                    t += S
                    continue
                eff = window_draws(ranked if rowshard else shared,
                                   (S, geo.G, geo.PL), cfg.window)
                negs = table[torch.randint(
                    0, table.shape[0], (S, geo.G2, k_shared),
                    generator=ranked, device=device)]
                w, lc, pc = chunk(w, shuffled, eff, negs, cfg.alpha,
                                  cfg.min_alpha, t, total_steps, **kw)
                losses.append(lc)
                pairs.append(pc)
                t += S
                n_chunk_calls += 1
                if metrics is not None:
                    metrics.log(kind="sgns_chunk_dist", epoch=epoch, step=t,
                                loss=round(float(lc.mean()), 5))
                maybe_save(
                    checkpoint_dir, checkpoint_every, n_chunk_calls,
                    lambda: {**{k: w[:, c] for k, c in parts.items()},
                             "step": t, "rng": shared.get_state(),
                             "rng_epoch": rng_epoch,
                             "rng_rank": ranked.get_state()},
                    save=lambda p, st: save_sharded(p, st, mesh))
        self.trained_pairs_ = (float(torch.cat(pairs).sum()) if pairs
                               else 0.0)
        if rowshard:
            full = comm.all_gather(w, mesh.get_group("data")).reshape(
                -1, 2 * D)[:num_nodes]
        else:
            shards = comm.all_gather(w, mesh.get_group("model"))
            full = torch.cat([shards[:, :, :Dl].permute(1, 0, 2).reshape(
                num_nodes, D), shards[:, :, Dl:].permute(1, 0, 2).reshape(
                num_nodes, D)], 1)
        losses = torch.cat(losses) if losses else torch.zeros(0,
                                                              device=device)
        return full[:, :D], full[:, D:], losses
