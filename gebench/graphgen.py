"""A cell's graph, made on the device from the run's seed.

Copied from `graphembedding_tpu_torch/benchmarks/million.py`
(`synthetic_graph`, `_undirected_csr`, `random_edge_count`), so that the
benchmark makes its own inputs: a ring (connectivity) plus random edges
with a hub skew, sources uniform and targets floor(U^2 * V), every loop
moved to (d + 1) % V, both directions, sorted by (source, target) into a
CSR. Returned as tensors; the harness hands them to the program as a
`Graph.from_csr` and keeps them for the reference.
"""

from __future__ import annotations

import torch


def random_edge_count(V: int, avg_degree: int) -> int:
    """The random edges added to the ring: V * max(avg_degree - 2, 1) //
    2."""
    return V * max(avg_degree - 2, 1) // 2


def undirected_csr(src, dst, V):
    """(row_ptr int64 [V + 1], col int32 [2 E]) of the undirected graph of
    edges (src, dst), loops moved to (d + 1) % V."""
    dst = torch.where(src == dst, (dst + 1) % V, dst)
    s2 = torch.cat([src, dst])
    d2 = torch.cat([dst, src])
    key = torch.sort(s2 * V + d2).values
    s2, d2 = key // V, key % V
    row_ptr = torch.zeros(V + 1, dtype=torch.int64, device=src.device)
    row_ptr[1:] = torch.cumsum(torch.bincount(s2, minlength=V), 0)
    return row_ptr, d2.to(torch.int32)


def synthetic_csr(V: int, avg_degree: int, seed: int, device):
    """The ring plus `random_edge_count` skewed random edges, drawn from a
    generator on `device` seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_rand = random_edge_count(V, avg_degree)
    ring = torch.arange(V, dtype=torch.int64, device=device)
    src = torch.randint(0, V, (n_rand,), generator=gen, device=device)
    u = torch.rand(n_rand, generator=gen, device=device)
    dst = (u ** 2 * V).to(torch.int64) % V
    return undirected_csr(torch.cat([ring, src]),
                          torch.cat([(ring + 1) % V, dst]), V)
