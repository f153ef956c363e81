"""DeepWalk (Perozzi et al., KDD'14): uniform walks + skip-gram.

Counterpart of `graphembedding_tpu/models/deepwalk.py`: the walks are
generated at construction on `device` (`ops.walk.simulate_walks`), and
`train` fits walk-block SGNS on the same device.
"""

from __future__ import annotations

import torch

from graphembedding_tpu_torch.models.base import WalkEmbeddingModel
from graphembedding_tpu_torch.ops.walk import simulate_walks


class DeepWalk(WalkEmbeddingModel):
    def __init__(self, graph, walk_length=10, num_walks=80, workers=1,
                 seed=0, device="cuda", mesh=None):
        del workers  # reference API parity
        if mesh is not None:
            raise NotImplementedError(
                "mesh= is not ported to graphembedding_tpu_torch")
        super().__init__(graph, walk_length, num_walks, seed, device)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        self.walks = simulate_walks(self.graph.to(self.device), num_walks,
                                    walk_length, generator=gen)

    def train(self, embed_size=128, window_size=5, workers=None, iter=5,
              **kwargs):
        return self._fit_skipgram(embed_size=embed_size,
                                  window_size=window_size, workers=workers,
                                  iter=iter, **kwargs)
