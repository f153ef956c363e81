"""Scaling of the mesh paths: trained pairs/s and walked edges/s at 1..N
ranks, as JSON lines.

Port of the JAX package's `benchmarks/scaling.py`, on the port's mesh
(`parallel/`): each world size of `--world` is one spawn of that many ranks
(`parallel.launch.run_ranks`) on the Wiki graph, and prints the JAX rows:

- `train_dp_{weak,strong}`: dp SGNS chunks (`parallel/sgns.py::
  sharded_sgns_chunk`, 16 steps, k_shared 32, block 32 walks a rank under
  weak scaling, 32 * max(world) in all under strong), the replicas synced
  every 4 steps: `pairs_per_s` (the chunks' own pair counts over the best
  of `--reps` timed runs of `--chunks` chunks), `scaling_efficiency`
  (rate(n) / (n / n0 * rate(n0)) weak, rate(n) / rate(n0) strong, n0 the
  first world size), `comm_efficiency` (t(sync every 16 steps, the chunk's end
  only) / t(sync every 4), at most 1: the share of the time not spent in
  the extra exchanges) and `seconds`;
- `rowshard` at the largest world size (`parallel/rowshard.py::
  rowsharded_sgns_chunk`, 32 walks a rank): `pairs_per_s`, `seconds`;
- `distributed_walks{,_a2a}_{weak,strong}` (`parallel/walks.py::
  DistributedWalker`, uniform, the all-gather and the crossers-only a2a
  engine, `--walkers` a rank, the locality relabeling by default):
  `walked_edges_per_s` (edges counted on real rows only: the engine's
  filler rows start at -1), `scaling_efficiency`, `comm_efficiency` (the
  engine with `route_off=True`, the exchange skipped, a timing control
  without meaning, against the engine), `routing_rounds`, `overflow`, and
  for a2a `crossed_rows_total` and `crossed_per_shard_round`.

Every row also carries `backend` and the card's name and power limit. A
run's time is the slowest rank's, host clock around synchronized work; the
first chunk or walk of each configuration is an untimed warm-up (over
NCCL it captures the chunk's CUDA graph).

    python -m graphembedding_tpu_torch.benchmarks.scaling [--world 1 2 4]
        [--backend nccl|gloo] [--device cuda|cpu] [--scaling weak|strong]
        [--walkers 4096] [--length 10] [--chunks 8] [--reps 3]
        [--relabel locality|none] [--nodes N] [--out rows.jsonl]

Runs on the card unless `--device cpu` (gloo only). NCCL puts rank r on
card r, so it needs as many cards as ranks: on a one-card machine it runs
world 1 only. World 2 over gloo runs both ranks on one card and stages every
exchange through host memory; a staged exchange cannot be captured, so its
chunks keep the step loop (`parallel/comm.py::host_staged`). Such rows
measure the exchange's cost and check the path, not scaling. `--nodes N`
takes a synthetic Wiki-like graph of N nodes in place of Wiki (for small
runs).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from graphembedding_tpu_torch.benchmarks.million import card_line

S, D, W, NEGATIVE, K_SHARED, SYNC_EVERY = 16, 128, 5, 5, 32, 4
WALKS_PER_NODE = 10  # the training corpus
BLOCK_WALKS = 32  # a rank's block under weak scaling


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, nargs="+", default=[1],
                    help="world sizes, one spawn of ranks each")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--walkers", type=int, default=4096,
                    help="walkers a rank (weak) / in all // max world "
                    "(strong)")
    ap.add_argument("--length", type=int, default=10)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--scaling", choices=("weak", "strong"), default="weak")
    ap.add_argument("--relabel", choices=("none", "locality"),
                    default="locality")
    ap.add_argument("--nodes", type=int, default=0,
                    help="a synthetic graph of this many nodes (0: Wiki)")
    ap.add_argument("--out", default=None, help="JSONL output path")
    args = ap.parse_args(argv)
    if args.backend == "nccl" and torch.device(args.device).type != "cuda":
        ap.error("--backend nccl runs on cards only")
    return args


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _slowest(seconds, mesh):
    """The largest of the ranks' seconds (every rank calls it)."""
    import torch.distributed as dist

    on = "cpu" if dist.get_backend() == "gloo" else mesh.device
    t = torch.tensor([seconds], dtype=torch.float64, device=on)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t[0])


def _best(run, mesh, reps):
    """(best seconds, what run() returned in that rep) over `reps` timed
    calls of run(r) between a barrier and a synchronize."""
    import torch.distributed as dist

    best, out = float("inf"), None
    for r in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        got = run(r)
        _sync(mesh.device)
        dt = _slowest(time.perf_counter() - t0, mesh)
        if dt < best:
            best, out = dt, got
    return best, out


def time_train(mesh, walks, table, V, bw, sync_every, args, rowshard=False):
    """(trained pairs/s, seconds) of the best of `args.reps` runs of
    `args.chunks` dp (or rowshard) chunks over V rows after a warm chunk."""
    from graphembedding_tpu_torch.parallel.mesh import rank_seed
    from graphembedding_tpu_torch.parallel.rowshard import (
        rank_geometry, rowsharded_sgns_chunk)
    from graphembedding_tpu_torch.parallel.sgns import (
        dp_geometry, sharded_sgns_chunk)
    from graphembedding_tpu_torch.train.skipgram import window_draws

    dev = mesh.device
    n, di = mesh.size("data"), mesh.get_local_rank("data")
    NW, L = walks.shape
    nsp = 4
    geo = (rank_geometry if rowshard else dp_geometry)(NW, L, bw, n, nsp)
    init = torch.Generator(device=dev).manual_seed(1)
    w_in = (torch.rand((V, D), generator=init, device=dev) - 0.5) / D
    if rowshard:
        Vp = -(-V // n)
        w = torch.zeros((Vp, 2 * D), device=dev)
        rows = w_in[di * Vp:(di + 1) * Vp]
        w[:rows.shape[0], :D] = rows
    else:
        w = torch.cat([w_in, torch.zeros((V, D), device=dev)], 1)
    shared = torch.Generator(device=dev).manual_seed(2)
    ranked = torch.Generator(device=dev).manual_seed(rank_seed(2, di))
    K = min(K_SHARED, V)
    kw = dict(mesh=mesh, block_walks=bw, window=W, negative=NEGATIVE,
              neg_share_packs=nsp)
    if not rowshard:
        kw["sync_every"] = sync_every

    def chunk(t):
        # the draws inside the timed span, as the JAX chunk makes its own
        eff = window_draws(ranked if rowshard else shared,
                           (S, geo.G, geo.PL), W)
        negs = table[torch.randint(0, table.shape[0], (S, geo.G2, K),
                                   generator=ranked, device=dev)]
        fn = rowsharded_sgns_chunk if rowshard else sharded_sgns_chunk
        return fn(w, walks, eff, negs, 0.025, 1e-4, t, 1e4, **kw)[2]

    chunk(0)

    def run(r):
        return torch.stack([chunk(S * (c + 1)) for c in range(args.chunks)])

    best, pairs = _best(run, mesh, args.reps)
    return float(pairs.sum()) / best, best


def time_walks(mesh, graph, nw, args, control, exchange):
    """One engine's warm walk, then its best timed run of `args.reps`:
    (seconds, walked edges/s, overflow, rounds, crossed rows)."""
    from graphembedding_tpu_torch.parallel.walks import DistributedWalker

    walker = DistributedWalker(
        graph, mesh, args.length, kind="uniform", num_walks=nw,
        route_off=control, exchange=exchange,
        relabel=None if args.relabel == "none" else args.relabel)
    _, overflow = walker.run_device(3)
    overflow = int(overflow)
    best, best_rate = float("inf"), 0.0
    for r in range(args.reps):
        # each seed walks its own edge count (dead ends), so each rep's
        # rate pairs its own edges with its own time
        dt, (wd, ov) = _best(lambda _: walker.run_device(4 + r), mesh, 1)
        best = min(best, dt)
        overflow = max(overflow, int(ov))
        edges = int((wd >= 0).sum() - (wd[:, 0] >= 0).sum())
        best_rate = max(best_rate, edges / dt)
    return best, best_rate, overflow, walker.last_rounds, walker.last_crossed


def rank_main(info, args, worlds):
    """Every measurement of one world size, in one rank; rank 0's dict of
    raw numbers is the result."""
    from graphembedding_tpu_torch.data import load_dataset, synthetic_wiki
    from graphembedding_tpu_torch.ops.walk import simulate_walks
    from graphembedding_tpu_torch.parallel.mesh import make_mesh, put_global
    from graphembedding_tpu_torch.train.skipgram import (
        corpus_counts, negative_table)

    dev = info.device
    if args.backend == "nccl":  # rank r on card r
        dev = torch.device("cuda", info.rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    n = info.world_size
    mesh = make_mesh((n, 1), device=dev)
    ds = (synthetic_wiki(num_nodes=args.nodes) if args.nodes
          else load_dataset("wiki"))
    g = ds.graph
    V = g.num_nodes
    gen = torch.Generator(device=dev).manual_seed(0)
    walks = put_global(simulate_walks(g, WALKS_PER_NODE, args.length,
                                      generator=gen), mesh)
    table = torch.as_tensor(negative_table(corpus_counts(walks, V)),
                            device=dev)
    out = {"devices": n}
    top = max(worlds)
    bw = (BLOCK_WALKS * n if args.scaling == "weak"
          else BLOCK_WALKS * top)
    out["train"] = time_train(mesh, walks, table, V, bw, SYNC_EVERY, args)
    # the control: no syncs inside the chunk, the one at its end only
    out["train_control"] = time_train(mesh, walks, table, V, bw, S, args)
    if n == top:
        out["rowshard"] = time_train(mesh, walks, table, V, BLOCK_WALKS * n,
                                     None, args, rowshard=True)
    per = args.walkers * (n if args.scaling == "weak" else top)
    nw = max(round(per / V), 1)
    for tag, exchange in (("", None), ("_a2a", "a2a")):
        full = time_walks(mesh, g, nw, args, False, exchange)
        ctl = time_walks(mesh, g, nw, args, True, exchange)
        out[f"walks{tag}"] = (full, ctl[0])
    return out if info.rank == 0 else None


def rows_of(results, args, card):
    """The JAX harness's rows, in its order, from each world's raw
    numbers (the first world size the base of the efficiencies)."""
    rows = []
    weak = args.scaling == "weak"

    def add(row):
        row.update(backend=args.backend, card=card)
        rows.append(row)

    n0, base = results[0]["devices"], results[0]["train"][0]
    for res in results:
        n = res["devices"]
        rate, t_full = res["train"]
        t_ctl = res["train_control"][1]
        add({"devices": n, "mode": f"train_dp_{args.scaling}",
             "pairs_per_s": rate,
             "scaling_efficiency": rate / (base * (n / n0 if weak else 1)),
             "comm_efficiency": min(t_ctl / t_full, 1.0),
             "seconds": t_full})
    last = results[-1]
    rate, t = last["rowshard"]
    add({"devices": last["devices"], "mode": "rowshard",
         "pairs_per_s": rate, "seconds": t})
    for tag in ("", "_a2a"):
        base = None
        for res in results:
            n = res["devices"]
            (t_full, rate, overflow, rounds, crossed), t_ctl = res[
                f"walks{tag}"]
            per_rank = rate / n
            base = base or per_rank
            row = {"devices": n,
                   "mode": f"distributed_walks{tag}_{args.scaling}",
                   "walked_edges_per_s": rate,
                   "scaling_efficiency": per_rank / base,
                   "comm_efficiency": min(t_ctl / t_full, 1.0),
                   "routing_rounds": rounds, "overflow": overflow,
                   "seconds": t_full}
            if crossed is not None:
                row["crossed_rows_total"] = crossed
                if rounds:
                    row["crossed_per_shard_round"] = crossed / (rounds * n)
            add(row)
    return rows


def main(argv=None):
    """Run every world size, print the rows as JSON lines; returns them."""
    from graphembedding_tpu_torch.parallel.launch import run_ranks

    args = parse_args(argv)
    device = torch.device(args.device)
    card = card_line(device)
    worlds = sorted(set(args.world))
    if args.backend == "nccl" and max(worlds) > torch.cuda.device_count():
        raise SystemExit(
            f"--backend nccl puts a rank on each card: world {max(worlds)} "
            f"needs {max(worlds)} cards, this machine has "
            f"{torch.cuda.device_count()}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)  # each rank sets its card
    results = [run_ranks(rank_main, n, args, worlds, backend=args.backend,
                         device=str(device))[0] for n in worlds]
    rows = rows_of(results, args, card)
    for row in rows:
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
