"""The reference's walker classes, `RandomWalker` and `BiasedWalker`.

Counterpart of `graphembedding_tpu/walker.py`: the same constructor
signatures (plus `device=`, the card unless the caller names the CPU), and
`simulate_walks` returns walks as lists of node names, the reference's
"sentences". The walks themselves are the port's batched walks on the
device: `ops.walk.simulate_walks` and `models.struc2vec.multilayer_walks`.
"""

from __future__ import annotations

import glob
import os
import pickle
from typing import List

import numpy as np
import torch

from graphembedding_tpu_torch.models.base import as_graph, model_device
from graphembedding_tpu_torch.models.struc2vec import (
    layers_to,
    multilayer_walks,
)
from graphembedding_tpu_torch.ops.walk import pq_sampler, simulate_walks


def _to_sentences(walks: torch.Tensor, idx2node) -> List[List]:
    return [[idx2node[i] for i in row if i >= 0]
            for row in walks.cpu().numpy()]


def _call_generator(device, seed, default_seed, calls):
    """The generator of one `simulate_walks` call: seeded with `seed`, or,
    for seed=None, with a hash of (default_seed, calls), so that each call
    of a walker draws a stream of its own that the next run repeats (the
    JAX package folds the call count into its key; seed + calls would give
    walker(seed=s)'s call k the stream of walker(seed=s + k)'s call 0)."""
    if seed is None:
        seed = int(np.random.SeedSequence([default_seed, calls])
                   .generate_state(1, np.uint64)[0] >> np.uint64(1))
    return torch.Generator(device=device).manual_seed(seed)


class RandomWalker:
    def __init__(self, G, p=1.0, q=1.0, use_rejection_sampling=0, seed=0,
                 device="cuda"):
        self.graph = as_graph(G)
        self.p = p
        self.q = q
        self.use_rejection_sampling = use_rejection_sampling
        self.seed = seed
        self.device = model_device(device)
        self._calls = 0  # advances the default stream call to call

    def preprocess_transition_probs(self):
        """Build the graph's alias tables on the device (once; the exact
        (p,q) sampler needs no per-edge tables)."""
        self.graph.alias_tables(self.device)
        return self

    def simulate_walks(self, num_walks, walk_length, workers=1, verbose=0,
                       seed=None):
        """num_walks walks of walk_length from every node, as lists of node
        names: uniform for p = q = 1, else node2vec's (p,q) walk (the exact
        sampler unless use_rejection_sampling).

        `seed=None` draws a fresh corpus on each call (the reference's RNG
        advances between calls too); pass `seed=` for a given corpus.
        """
        del workers, verbose
        gen = _call_generator(self.device, seed, self.seed, self._calls)
        if seed is None:
            self._calls += 1
        g = self.graph
        if self.p == 1.0 and self.q == 1.0:
            walks = simulate_walks(g, num_walks, walk_length, generator=gen)
        else:
            walks = simulate_walks(
                g, num_walks, walk_length, generator=gen, kind="node2vec",
                p=self.p, q=self.q,
                sampler=pq_sampler(g.num_nodes, g.max_degree,
                                   bool(self.use_rejection_sampling)))
        return _to_sentences(walks, g.vocab.idx2node)


class BiasedWalker:
    """Struc2Vec's multilayer walker.

    The reference's reads pickled per-layer alias tables from `temp_path`.
    Here the layers are the stacked-CSR dict of
    `models.struc2vec.build_layer_csr`, taken from `layers=` when given,
    else from the newest `context_*.pkl` in `temp_path` (the cache the
    `Struc2Vec` model writes there); `simulate_walks` runs the batched
    multilayer walk on the device (`models.struc2vec.multilayer_walks`).
    """

    def __init__(self, idx2node, temp_path, layers=None, seed=0,
                 device="cuda"):
        self.idx2node = idx2node
        self.temp_path = temp_path
        self._layers = layers
        self.seed = seed
        self.device = model_device(device)
        self._calls = 0  # advances the default stream call to call

    def _resolve_layers(self):
        if self._layers is not None:
            return self._layers
        cands = sorted(
            glob.glob(os.path.join(self.temp_path, "context_*.pkl")),
            key=os.path.getmtime)
        if not cands:
            raise FileNotFoundError(
                f"no context_*.pkl layer cache under {self.temp_path!r}; "
                "construct Struc2Vec(graph, temp_path=...) first (it builds "
                "and caches the context graph), or pass layers= (the "
                "models.struc2vec.build_layer_csr dict) directly")
        with open(cands[-1], "rb") as f:
            self._layers = pickle.load(f)
        return self._layers

    def simulate_walks(self, num_walks, walk_length, stay_prob=0.3,
                       workers=1, verbose=0, seed=None):
        """num_walks multilayer walks from every node, as lists of node
        names; `seed` as in `RandomWalker.simulate_walks`."""
        del workers, verbose
        gen = _call_generator(self.device, seed, self.seed, self._calls)
        if seed is None:
            self._calls += 1
        ly = layers_to(self._resolve_layers(), self.device)
        V = ly["row_ptr"].shape[1] - 1
        starts = torch.arange(V, dtype=torch.int32,
                              device=self.device).repeat(num_walks)
        walks = multilayer_walks(ly["row_ptr"], ly["col_idx"], ly["accept"],
                                 ly["alias"], ly["gamma"], starts, gen,
                                 stay_prob, length=walk_length)
        return _to_sentences(walks, self.idx2node)
