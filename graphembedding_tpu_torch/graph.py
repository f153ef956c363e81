"""Host CSR graph with a PyTorch device view.

Counterpart of `graphembedding_tpu/graph.py`: the same host build (edges
sorted by (src, dst), so columns are sorted within each row), the same
constructors, and `Graph.to(device)` in place of the JAX package's
`Graph.device`. The device view is not padded: the 128-lane padding of the
JAX package is a TPU tiling rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from graphembedding_tpu_torch.utils.vocab import IdentityVocab, Vocab


@dataclass
class DeviceGraph:
    """The CSR on one device. Values are int32; `row_ptr` is int64
    because it is added to and used as an index on every walk hop."""

    row_ptr: torch.Tensor  # i64 [V+1]
    col_idx: torch.Tensor  # i32 [E]
    degree: torch.Tensor  # i32 [V]
    num_nodes: int


class Graph:
    """Host-canonical CSR graph.

    Parameters
    ----------
    src, dst : int arrays of edge endpoints (vocab indices)
    weight : float array of edge weights (ones when None)
    num_nodes : total vertex count (isolated vertices allowed)
    vocab : optional node-name vocabulary
    directed : whether (src, dst) already lists each direction. If False,
        the reverse of every edge that is not a self-loop is added.
    """

    def __init__(
        self,
        src: np.ndarray,
        dst: np.ndarray,
        weight: Optional[np.ndarray] = None,
        *,
        num_nodes: Optional[int] = None,
        vocab=None,
        directed: bool = True,
    ):
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if weight is None:
            weight = np.ones(src.shape[0], dtype=np.float32)
        weight = np.asarray(weight, dtype=np.float32)
        if not directed:
            # a self-loop appears once in its row, not twice
            m = src != dst
            src, dst = (
                np.concatenate([src, dst[m]]),
                np.concatenate([dst, src[m]]),
            )
            weight = np.concatenate([weight, weight[m]])

        if num_nodes is None:
            num_nodes = int(max(src.max(initial=-1), dst.max(initial=-1)) + 1)
        self.num_nodes = int(num_nodes)
        self.directed = directed
        self.vocab = vocab if vocab is not None else IdentityVocab(
            self.num_nodes)

        order = np.lexsort((dst, src))
        src, dst, weight = src[order], dst[order], weight[order]
        self.num_edges = int(src.shape[0])
        counts = np.bincount(src, minlength=self.num_nodes)
        self.row_ptr = np.zeros(self.num_nodes + 1, dtype=np.int32)
        np.cumsum(counts, out=self.row_ptr[1:])
        self.col_idx = dst.astype(np.int32)
        self.edge_weight = weight
        self.degree = counts.astype(np.int32)
        self.max_degree = int(counts.max(initial=0))

    @classmethod
    def from_nx(cls, graph) -> "Graph":
        """Build from a networkx (Di)Graph; indices follow `graph.nodes()`
        order and an undirected graph contributes both directions."""
        vocab = Vocab(graph.nodes())
        n_edges = graph.number_of_edges()
        src = np.empty(n_edges, dtype=np.int64)
        dst = np.empty(n_edges, dtype=np.int64)
        w = np.empty(n_edges, dtype=np.float32)
        for i, (u, v, data) in enumerate(graph.edges(data=True)):
            src[i] = vocab[u]
            dst[i] = vocab[v]
            w[i] = float(data.get("weight", 1.0))
        return cls(src, dst, w, num_nodes=len(vocab), vocab=vocab,
                   directed=graph.is_directed())

    @classmethod
    def from_edgelist(cls, path: str, *, directed: bool = True,
                      weighted: bool = False) -> "Graph":
        """Load an edgelist file (`src dst [weight]` per line, whitespace-
        or comma-separated; `#` starts a comment line)."""
        vocab = Vocab()
        srcs, dsts, ws = [], [], []
        with open(path) as f:
            for line in f:
                parts = line.replace(",", " ").split()
                if not parts or parts[0].startswith("#"):
                    continue
                srcs.append(vocab.add(parts[0]))
                dsts.append(vocab.add(parts[1]))
                ws.append(float(parts[2]) if weighted and len(parts) > 2
                          else 1.0)
        return cls(np.array(srcs), np.array(dsts),
                   np.array(ws, dtype=np.float32), num_nodes=len(vocab),
                   vocab=vocab, directed=directed)

    def to(self, device) -> DeviceGraph:
        """The CSR as tensors on `device` (a new copy on every call)."""
        return DeviceGraph(
            row_ptr=torch.as_tensor(self.row_ptr.astype(np.int64),
                                    device=device),
            col_idx=torch.as_tensor(self.col_idx, device=device),
            degree=torch.as_tensor(self.degree, device=device),
            num_nodes=self.num_nodes,
        )

    def neighbors(self, v: int) -> np.ndarray:
        return self.col_idx[self.row_ptr[v]: self.row_ptr[v + 1]]

    def edges(self):
        """(src, dst, weight) int64/int64/f32 arrays in CSR order."""
        src = np.repeat(np.arange(self.num_nodes, dtype=np.int64),
                        np.diff(self.row_ptr))
        return src, self.col_idx.astype(np.int64), self.edge_weight

    def __repr__(self):
        return (f"Graph(V={self.num_nodes}, E={self.num_edges}, "
                f"directed={self.directed}, max_degree={self.max_degree})")
