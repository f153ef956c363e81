"""Walks and training over several ranks with torch.distributed: the
counterpart of `graphembedding_tpu/parallel/`.

    # in every rank's process
    init_distributed(rank, world_size, "nccl", "file:///tmp/x/store")
    mesh = make_mesh((world_size, 1), device="cuda")
    DeepWalk(G, device="cuda").train(mesh=mesh)          # rowshard
    DeepWalk(G, device="cuda").train(mesh=mesh, parallel_mode="dp")
    DeepWalk(G, device="cuda", mesh=mesh).train()        # walks too
    DistributedWalker(G, mesh, 10, num_walks=80).run(seed)

`launch.run_ranks` spawns the ranks of a function and gathers their
results (the tests and chip_smoke.py use it).
"""

from graphembedding_tpu_torch.parallel.mesh import (
    Mesh,
    init_distributed,
    make_mesh,
    put_global,
)
from graphembedding_tpu_torch.parallel.trainer import (
    DistributedSkipGramTrainer,
)
from graphembedding_tpu_torch.parallel.walks import DistributedWalker

__all__ = ["Mesh", "init_distributed", "make_mesh", "put_global",
           "DistributedSkipGramTrainer", "DistributedWalker"]
