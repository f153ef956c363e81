"""DeepWalk over ranks in processes of their own: the multi-host example.

Run one copy of this script a process, each with its own --process-id:

    python -m graphembedding_tpu_torch.examples.deepwalk_multihost \
        --coordinator localhost:29511 --num-processes 2 --process-id 0 &
    python -m graphembedding_tpu_torch.examples.deepwalk_multihost \
        --coordinator localhost:29511 --num-processes 2 --process-id 1

(`--device cpu` on the CPU; two processes on one card: `--device cuda:0
--backend gloo`). Without --coordinator the ranks join from the
environment `torchrun` sets. Every process runs the same program: it builds
the same graph from one seed, makes the (world size, 1) mesh, walks over it
(`DeepWalk(mesh=)`, the all-gather or the a2a engine) and trains over it
(rowshard or dp); rank 0 prints micro-F1, the walk overflow and the
process count.

Counterpart of the JAX package's `examples/deepwalk_multihost.py`.
"""

from __future__ import annotations

import argparse
import json
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="address of process 0 (omit under torchrun)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (each process on the card of its local "
                        "rank), 'cuda:N' or 'cpu'")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="default: nccl for a CUDA device, gloo for the CPU "
                        "(gloo for processes that share one card)")
    p.add_argument("--nodes", type=int, default=120)
    p.add_argument("--walk-length", type=int, default=10)
    p.add_argument("--num-walks", type=int, default=20)
    p.add_argument("--iter", type=int, default=3)
    p.add_argument("--mode", default="dp", choices=("dp", "rowshard"),
                   help="training over the mesh (parallel/trainer.py)")
    p.add_argument("--walk-engine", default="default",
                   choices=("default", "a2a"),
                   help="distributed walk exchange: the all-gather router "
                        "or the crossers-only all-to-all "
                        "(parallel/walks.py)")
    p.add_argument("--json", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import torch

    from graphembedding_tpu_torch.data.datasets import synthetic_wiki
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.models import DeepWalk
    from graphembedding_tpu_torch.parallel.mesh import (
        destroy_distributed,
        init_distributed,
        make_mesh,
    )

    if args.coordinator:
        rank, world = args.process_id, args.num_processes
        if rank is None or world is None:
            raise SystemExit("--coordinator needs --num-processes and "
                             "--process-id")
        init_method = f"tcp://{args.coordinator}"
        local_rank = rank
    else:
        rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        init_method = "env://"
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    device = torch.device(args.device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    init_distributed(rank, world, backend, init_method)
    try:
        # one seed on every process: the same graph everywhere
        ds = synthetic_wiki(num_nodes=args.nodes, num_classes=3,
                            avg_degree=8, seed=5)
        mesh = make_mesh((world, 1), device=device)
        if rank == 0 and not args.json:
            print(f"processes={world} backend={backend} device={device}")
        m = DeepWalk(ds.graph, walk_length=args.walk_length,
                     num_walks=args.num_walks, device=device, mesh=mesh,
                     walk_exchange=(None if args.walk_engine == "default"
                                    else args.walk_engine))
        m.train(embed_size=32, window_size=5, iter=args.iter,
                block_walks=8 * world, parallel_mode=args.mode)
        # every rank holds the whole table; rank 0 reports
        if rank == 0:
            res = Classifier(m.get_embeddings()).split_train_evaluate(
                ds.X, ds.Y, 0.8)
            out = {"micro_f1": round(res["micro"], 4),
                   "walk_overflow": m.walk_overflow, "processes": world}
            print(json.dumps(out) if args.json else out, flush=True)
    finally:
        destroy_distributed()


if __name__ == "__main__":
    main()
