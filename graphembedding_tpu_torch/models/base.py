"""Shared machinery of the walk + skip-gram models.

Counterpart of `graphembedding_tpu/models/base.py`: the walk-block SGNS
trainer, the hierarchical-softmax trainer with `hs=1`, or the closed-form
expected-SGNS fit with `trainer='dense'`. The first two take
`checkpoint_dir=` / `checkpoint_every=` (resume from the checkpoint in the
directory, bit-identical to an uninterrupted train) and `metrics=` (a
`utils.metrics.MetricsLogger`, one line a chunk). Both take `mesh=` (a
`parallel.mesh.Mesh`: every rank's process calls `train` on its own model,
and the walks of rank 0 are trained; `parallel_mode='rowshard'` or `'dp'`
for SGNS, data- and tensor-parallel chunks for hs=1); a model built with
`mesh=` walks over that mesh (`parallel.walks.DistributedWalker`) and
trains over it unless `train` is given another. Models accept a
networkx graph or a `graphembedding_tpu_torch.Graph`, and run on the
`device` they are given: the CUDA card by default, the CPU only when the
caller asks for it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.parallel.mesh import check_mesh
from graphembedding_tpu_torch.parallel.trainer import (
    DistributedSkipGramTrainer,
)
from graphembedding_tpu_torch.parallel.walks import DistributedWalker
from graphembedding_tpu_torch.train.dense import DenseSGNSTrainer
from graphembedding_tpu_torch.train.hsoftmax import HSTrainer
from graphembedding_tpu_torch.train.skipgram import (
    SkipGramConfig,
    SkipGramTrainer,
)

# options of the JAX package's trainer that the port does not have
_NOT_PORTED = ("shuffle_mode", "use_pallas", "matmul_bf16", "stale_groups")


def as_graph(graph) -> Graph:
    return graph if isinstance(graph, Graph) else Graph.from_nx(graph)


def model_device(device) -> torch.device:
    """The device a model runs on: the card unless the caller names the CPU.
    A CUDA device where there is no card raises; nothing falls back to the
    CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but torch sees no CUDA card; "
            f"pass device='cpu' to run on the CPU")
    return device


class WalkEmbeddingModel:
    """Base of DeepWalk, Node2Vec and Struc2Vec: walks -> SGNS or
    hierarchical softmax -> embedding table."""

    def __init__(self, graph, walk_length: int, num_walks: int,
                 seed: int = 0, device="cuda", mesh=None):
        # the constructor's mesh: walks and train over it
        self.mesh = None if mesh is None else check_mesh(mesh)
        self.device = model_device(device)
        self.graph = as_graph(graph)
        self.walk_length = walk_length
        self.num_walks = num_walks
        self.seed = seed
        self.walk_overflow = 0  # walkers lost by the mesh walks
        self.walks = None  # int32 [num_walks * V, walk_length] on device
        self.w_in = None
        self.w_out = None
        self.losses = None
        self.trained_pairs = 0.0
        self._embeddings: Optional[Dict] = None

    def _mesh_walks(self, graph, **walker_kw):
        """The corpus walked over the model's mesh from its seed (every
        rank gets it whole), on the model's device; sets `walk_overflow`."""
        walker = DistributedWalker(graph, self.mesh, self.walk_length,
                                   num_walks=self.num_walks, **walker_kw)
        walks, self.walk_overflow = walker.run_tensor(self.seed)
        return walks.to(self.device)

    def _fit_skipgram(self, embed_size=128, window_size=5, workers=None,
                      iter=5, negative=5, alpha=0.025, min_alpha=1e-4,
                      block_walks=None, k_shared=64, sample=1e-3, mesh=None,
                      parallel_mode="rowshard", hs=0, trainer="block",
                      checkpoint_dir=None, checkpoint_every=0, metrics=None,
                      **kwargs):
        del workers
        if mesh is None:
            mesh = self.mesh
        if trainer == "dense":
            return self._fit_dense(embed_size, window_size, negative, hs,
                                   mesh, checkpoint_dir, metrics, kwargs)
        if trainer != "block":
            raise ValueError(f"unknown trainer {trainer!r}")
        for name in _NOT_PORTED:
            if name in kwargs:
                raise NotImplementedError(
                    f"{name}= is not ported to graphembedding_tpu_torch")
        fit_kw = dict(checkpoint_dir=checkpoint_dir,
                      checkpoint_every=checkpoint_every, metrics=metrics)
        if hs:
            if "cap_mode" in kwargs:
                # SGNS's cap_mode is ported; the hierarchical-softmax
                # trainer has the dense cap only
                raise NotImplementedError(
                    "cap_mode= with hs=1 (the sparse cap of hierarchical "
                    "softmax) is not ported to graphembedding_tpu_torch")
            # as in the JAX package: window, epochs and seed kwargs win
            # over the explicit arguments, and seed + 1 seeds the fit
            seed = kwargs.get("seed", self.seed)
            hst = HSTrainer(embed_size=embed_size,
                            window=kwargs.get("window", window_size),
                            epochs=kwargs.get("epochs", iter), alpha=alpha,
                            min_alpha=min_alpha, sample=sample, seed=seed,
                            mesh=mesh)
            self.w_in, self.w_out, self.losses = hst.fit(
                self.walks, self.graph.num_nodes, seed=seed + 1, **fit_kw)
            self.trained_pairs = hst.trained_pairs_
            self._embeddings = None
            return self
        # kwargs that name config fields win over the explicit arguments,
        # as in the JAX package; other kwargs are accepted and ignored
        # (gensim keyword parity)
        cfg_fields = {f.name for f in dataclasses.fields(SkipGramConfig)}
        cfg_kw = dict(embed_size=embed_size, window=window_size,
                      negative=negative, epochs=iter, k_shared=k_shared,
                      alpha=alpha, min_alpha=min_alpha, sample=sample,
                      seed=self.seed)
        if block_walks is not None:
            cfg_kw["block_walks"] = block_walks
        cfg_kw.update({k: v for k, v in kwargs.items() if k in cfg_fields})
        cfg = SkipGramConfig(**cfg_kw)
        if mesh is not None:
            sgns = DistributedSkipGramTrainer(mesh, cfg, mode=parallel_mode)
            self.w_in, self.w_out, self.losses = sgns.fit(
                self.walks, self.graph.num_nodes, seed=cfg.seed + 1,
                **fit_kw)
        else:
            sgns = SkipGramTrainer(cfg)
            w_cat, self.losses = sgns.fit(self.walks, self.graph.num_nodes,
                                          seed=cfg.seed + 1, **fit_kw)
            D = cfg.embed_size
            self.w_in, self.w_out = w_cat[:, :D], w_cat[:, D:]
        self.trained_pairs = sgns.trained_pairs_
        self._embeddings = None
        return self

    def _fit_dense(self, embed_size, window_size, negative, hs, mesh,
                   checkpoint_dir, metrics, kwargs):
        """trainer='dense': the closed-form expected-SGNS fit
        (`train.dense`), with the JAX package's rules: window and seed
        kwargs win, steps, lr and max_nodes pass through, other kwargs are
        ignored, and seed + 1 draws the initial table."""
        if hs:
            raise ValueError("trainer='dense' trains the SGNS objective; "
                             "use hs=0")
        if mesh is not None or checkpoint_dir or metrics:
            raise ValueError(
                "trainer='dense' is the single-card small-graph path and "
                "does not support mesh=, checkpoint_dir= or metrics=")
        seed = kwargs.get("seed", self.seed)
        dtr = DenseSGNSTrainer(
            embed_size=embed_size, window=kwargs.get("window", window_size),
            negative=negative, seed=seed,
            **{k: kwargs[k] for k in ("steps", "lr", "max_nodes")
               if k in kwargs})
        self.w_in, self.w_out, self.losses = dtr.fit(
            self.walks, self.graph.num_nodes, seed=seed + 1)
        self.trained_pairs = 0.0  # an expectation: no pairs are sampled
        self._embeddings = None
        return self

    def get_embeddings(self) -> Dict:
        """{node_name: np.ndarray[embed_size]}, the reference's type."""
        if self._embeddings is None:
            if self.w_in is None:
                raise RuntimeError("call train() before get_embeddings()")
            table = self.w_in.detach().cpu().numpy()
            names = self.graph.vocab.idx2node
            self._embeddings = {names[i]: table[i]
                                for i in range(self.graph.num_nodes)}
        return self._embeddings

    @property
    def embedding_table(self) -> torch.Tensor:
        """The [V, D] input-embedding table on the model's device."""
        return self.w_in
