"""DeepWalk (Perozzi et al., KDD'14): uniform walks + skip-gram.

Counterpart of `graphembedding_tpu/models/deepwalk.py`: the walks are
generated at construction on `device` (`ops.walk.simulate_walks`), or over
a mesh (`parallel.walks`), and `train` fits walk-block SGNS on the same
device or mesh.
"""

from __future__ import annotations

import torch

from graphembedding_tpu_torch.models.base import WalkEmbeddingModel
from graphembedding_tpu_torch.ops.walk import simulate_walks
from graphembedding_tpu_torch.utils.profiling import span


class DeepWalk(WalkEmbeddingModel):
    def __init__(self, graph, walk_length=10, num_walks=80, workers=1,
                 seed=0, device="cuda", mesh=None, walk_exchange=None):
        """`mesh=` (a `parallel.mesh.Mesh`; every rank builds the model)
        walks over the mesh, the graph's rows split over its data axis;
        `train()` then defaults to the same mesh. `walk_exchange='a2a'`
        moves only the walkers that cross ranks, per destination (None:
        the all-gather engine, which wins on small meshes)."""
        del workers  # reference API parity
        super().__init__(graph, walk_length, num_walks, seed, device, mesh)
        if mesh is not None:
            self.walks = self._mesh_walks(self.graph, kind="uniform",
                                          exchange=walk_exchange)
        else:
            with span("walk", fit=self.fit_id):
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
                self.walks = simulate_walks(self.graph, num_walks,
                                            walk_length, generator=gen)

    def train(self, embed_size=128, window_size=5, workers=None, iter=5,
              **kwargs):
        return self._fit_skipgram(embed_size=embed_size,
                                  window_size=window_size, workers=workers,
                                  iter=iter, **kwargs)
