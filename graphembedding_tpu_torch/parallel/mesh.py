"""Process groups and the (data, model) mesh over them.

Counterpart of `graphembedding_tpu/parallel/mesh.py`. Each rank is a
process of its own, joined by `torch.distributed`: NCCL between cards, gloo
on the CPU or for ranks that share one card. Axes:

- `data`: walk-block (or edge-batch, or adjacency-row) data parallelism;
- `model`: embedding-dimension tensor parallelism (column-sharded tables,
  partial logits summed over the axis).

Rank r sits at (r // n_model, r % n_model). The mesh is the port's own small
class, not `torch.distributed.device_mesh.DeviceMesh`: DeviceMesh picks and
sets each rank's device itself (global rank modulo the card count), while
this class keeps the device the caller names, so two gloo ranks can share
one card and the same code runs on the CPU. It has DeviceMesh's accessors
`size(name)`, `get_group(name)` and `get_local_rank(name)`.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from graphembedding_tpu_torch.parallel import comm

AXES = ("data", "model")


def init_distributed(rank: int, world_size: int, backend: str = "nccl",
                     init_method: Optional[str] = None,
                     timeout_s: float = 600.0) -> None:
    """Join the process group (`torch.distributed.init_process_group`).

    `init_method` is a `tcp://host:port` or `file://path` URL (a file in a
    temporary directory lets many groups run side by side without ports).
    A failed join raises: nothing degrades to a single process, which would
    train unsynced models. NCCL ranks set their card with
    `torch.cuda.set_device` first.
    """
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized")
    dist.init_process_group(
        backend=backend, init_method=init_method, rank=rank,
        world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))


def destroy_distributed() -> None:
    """Leave the process group (`torch.distributed.destroy_process_group`)
    after releasing the chunk graphs that exchange over any of its groups:
    a captured NCCL collective holds its group's communicator, and a graph
    must not outlive it (`train.chunk_graph`)."""
    from graphembedding_tpu_torch.train import chunk_graph

    for group in {g for graph in chunk_graph.held() for g in graph.groups}:
        chunk_graph.release(group=group)
    dist.destroy_process_group()


class Mesh:
    """A (data, model) grid of the ranks of the default process group,
    with one process group for each line of each axis."""

    def __init__(self, shape: Tuple[int, int], device,
                 groups: Dict[str, object]):
        self.shape = dict(zip(AXES, shape))
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self._groups = groups

    def size(self, name: str = None) -> int:
        """Ranks along axis `name`, or in the whole mesh."""
        if name is None:
            return self.shape["data"] * self.shape["model"]
        return self.shape[name]

    def get_group(self, name: str = None):
        """The process group of this rank's line along `name` (None: the
        whole mesh, the default group)."""
        return None if name is None else self._groups[name]

    def get_local_rank(self, name: str) -> int:
        """This rank's coordinate along `name`."""
        d, m = divmod(self.rank, self.shape["model"])
        return d if name == "data" else m


def make_mesh(shape: Optional[Sequence[int]] = None,
              device="cuda") -> Mesh:
    """The (data, model) mesh over the ranks of the default group.

    Default shape (world size, 1): shallow models shard best over data.
    Every rank must call it, with the same shape: it creates the groups of
    every line of both axes in one order.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs init_distributed first")
    world = dist.get_world_size()
    n_data, n_model = (world, 1) if shape is None else tuple(shape)
    if n_data * n_model != world:
        raise ValueError(f"mesh shape {(n_data, n_model)} != {world} ranks")
    rank = dist.get_rank()
    groups = {}
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            groups["data"] = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            groups["model"] = g
    return Mesh((n_data, n_model), device, groups)


def check_mesh(mesh) -> Mesh:
    """mesh, or TypeError when it is not a `Mesh` (the JAX package's
    `jax.sharding.Mesh` has no counterpart here)."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh= takes a graphembedding_tpu_torch.parallel."
                        f"mesh.Mesh (make_mesh), got {type(mesh).__name__}")
    return mesh


def rank_seed(seed: int, index: int) -> int:
    """Seed of the per-rank stream `index` of a run seeded with `seed` (the
    port's counterpart of `jax.random.fold_in(key, index)`)."""
    return (int(seed) * 1_000_003 + 7_919 * (int(index) + 1)) % (1 << 62)


def put_global(x, mesh: Mesh, spec=None) -> torch.Tensor:
    """Rank 0's value of `x` on every rank, then this rank's shard by spec.

    spec None: replicated; ("data", None): rows split over the data axis;
    (None, "model"): columns split over the model axis (the axis' size
    must divide the dimension). Every rank passes a tensor of the same
    shape and dtype (checked): corpora built from one seed are equal, and
    taking rank 0's makes sure no rank trains on another.
    """
    x = torch.as_tensor(x).to(mesh.device).contiguous()
    shape = torch.tensor(list(x.shape) + [x.element_size()],
                         dtype=torch.int64, device=mesh.device)
    shapes = comm.all_gather(shape, None)
    if not bool((shapes == shape).all()):
        raise ValueError(f"put_global: ranks hold different shapes "
                         f"{shapes.tolist()}")
    x = comm.all_gather(x, None)[0]
    if spec is None or all(s is None for s in spec):
        return x
    for dim, name in enumerate(spec):
        if name is None:
            continue
        n = mesh.size(name)
        if x.shape[dim] % n:
            raise ValueError(f"put_global: dim {dim} ({x.shape[dim]}) does "
                             f"not split over {name} ({n})")
        part = x.shape[dim] // n
        x = x.narrow(dim, mesh.get_local_rank(name) * part, part)
    return x.contiguous()
