"""Uniform random walks (DeepWalk) in plain PyTorch.

Counterpart of `graphembedding_tpu/ops/walk.py::uniform_walks` and
`simulate_walks(kind='uniform')`. Every walker advances in lockstep: one
hop is two gathers (offset and degree of the current node), one uniform
draw and one gather from `col_idx`. A walk that reaches a node without
out-edges stops there and the rest of its row is -1. Walks are int32
[B, L]. The draws come from a `torch.Generator`, so the walks follow the
same distribution as the JAX package's, not the same values.
"""

from __future__ import annotations

import torch

from graphembedding_tpu_torch.graph import DeviceGraph


def uniform_walks(row_ptr, col_idx, degree, starts, *, length, generator):
    """DeepWalk walks from `starts` (int [B]): uniform next hop.

    row_ptr is int64 [V+1], col_idx int32 [E], degree int32 [V]. Returns
    int32 [B, length].
    """
    device = starts.device
    cur = starts.to(torch.int64)
    num_edges = col_idx.shape[0]
    # an empty edge list still needs one slot to gather from; every read
    # of it is masked because no node then has a neighbour
    col = (col_idx.to(torch.int64) if num_edges
           else torch.full((1,), -1, dtype=torch.int64, device=device))
    deg_all = degree.to(torch.int64)
    out = torch.empty((cur.shape[0], length), dtype=torch.int32,
                      device=device)
    out[:, 0] = cur.to(torch.int32)
    for t in range(1, length):
        alive = cur >= 0
        safe = cur.clamp(min=0)
        deg = torch.where(alive, deg_all[safe], 0)
        u = torch.rand(cur.shape, generator=generator, device=device)
        pick = torch.minimum((u * deg.to(torch.float32)).to(torch.int64),
                             (deg - 1).clamp(min=0))
        # a node without out-edges may sit at row_ptr == E: clamp the read
        slot = (row_ptr[safe] + pick).clamp(max=max(num_edges - 1, 0))
        cur = torch.where(deg > 0, col[slot], -1)
        out[:, t] = cur.to(torch.int32)
    return out


def simulate_walks(graph: DeviceGraph, num_walks: int, walk_length: int, *,
                   generator, kind: str = "uniform"):
    """The walk corpus [num_walks * V, walk_length] (int32): every vertex
    starts `num_walks` walks (`arange(V)` tiled `num_walks` times)."""
    if kind != "uniform":
        raise NotImplementedError(
            f"walk kind {kind!r} is not ported; only 'uniform' is")
    device = graph.row_ptr.device
    starts = torch.arange(graph.num_nodes, dtype=torch.int64,
                          device=device).repeat(num_walks)
    return uniform_walks(graph.row_ptr, graph.col_idx, graph.degree, starts,
                         length=walk_length, generator=generator)
