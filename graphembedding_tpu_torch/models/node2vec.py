"""Node2Vec (Grover & Leskovec, KDD'16): (p,q)-biased second-order walks +
skip-gram.

Counterpart of `graphembedding_tpu/models/node2vec.py`: the walks are
generated at construction on `device` (`ops.walk.simulate_walks(kind=
'node2vec')`), by the exact Gumbel-max sampler or the rejection sampler,
or over a mesh (`parallel.walks`), and `train` fits walk-block SGNS on the
same device or mesh.
"""

from __future__ import annotations

import torch

from graphembedding_tpu_torch.models.base import WalkEmbeddingModel
from graphembedding_tpu_torch.ops.walk import (
    PQ_BUDGET_BYTES,
    pq_sampler,
    simulate_walks,
)
from graphembedding_tpu_torch.utils.profiling import span


class Node2Vec(WalkEmbeddingModel):
    def __init__(self, graph, walk_length=10, num_walks=80, p=1.0, q=1.0,
                 workers=1, use_rejection_sampling=None, seed=0,
                 device="cuda", mesh=None):
        """`use_rejection_sampling=None` picks the sampler from the graph's
        degree profile and memory (`ops.walk.select_pq_kernel`, the JAX
        package's rule); True or False forces it (False: the exact
        sampler). `mesh=` walks over the mesh (the exact engine, or the
        CSR rejection engine for either rejection sampler; the memory
        budget of the choice times the data axis' size, as the rows are
        split over it); `train()` then defaults to the same mesh."""
        del workers  # reference API parity
        super().__init__(graph, walk_length, num_walks, seed, device, mesh)
        self.p = p
        self.q = q
        n_parts = mesh.size("data") if mesh is not None else 1
        self.sampler = pq_sampler(self.graph.num_nodes,
                                  self.graph.max_degree,
                                  use_rejection_sampling,
                                  hbm_budget_bytes=PQ_BUDGET_BYTES * n_parts)
        self.use_rejection_sampling = self.sampler != "exact"
        if mesh is not None:
            self.walks = self._mesh_walks(
                self.graph, p=p, q=q,
                kind=("node2vec_rejection" if self.use_rejection_sampling
                      else "node2vec"))
        else:
            with span("walk", fit=self.fit_id):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
                self.walks = simulate_walks(
                    self.graph, num_walks, walk_length, generator=gen,
                    kind="node2vec", p=p, q=q, sampler=self.sampler)

    def train(self, embed_size=128, window_size=5, workers=None, iter=5,
              **kwargs):
        return self._fit_skipgram(embed_size=embed_size,
                                  window_size=window_size, workers=workers,
                                  iter=iter, **kwargs)
