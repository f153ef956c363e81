"""Host CSR graph with a PyTorch device view.

Counterpart of `graphembedding_tpu/graph.py`: the same host build (edges
sorted by (src, dst), so columns are sorted within each row), the same
constructors, and `Graph.to(device)` in place of the JAX package's
`Graph.device`. Each view is built once and cached, as there: the CSR,
the per-row alias tables and weight sums, and the padded neighbor ids and
weights, once a device. No view is padded to 128 lanes: that is a TPU
tiling rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from graphembedding_tpu_torch.ops.alias import build_row_alias
from graphembedding_tpu_torch.utils.debug import (
    validate_graph,
    validation_enabled,
)
from graphembedding_tpu_torch.utils.vocab import IdentityVocab, Vocab


def row_weight_sums(row_ptr: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """f32 [V]: the sum of each CSR row's weights, taken per row in float64
    and then rounded once, so it holds at any edge count. (A difference of
    a global f32 prefix sum, as the JAX package takes it, loses rows past
    2^24 edges.) A row without edges sums to 0."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    out = np.zeros(row_ptr.shape[0] - 1, dtype=np.float64)
    # reduceat over the starts of the non-empty rows only: it would give
    # an element, not 0, for an empty row, and cannot take a start of E
    full = np.diff(row_ptr) > 0
    if full.any():
        out[full] = np.add.reduceat(
            np.asarray(weights, dtype=np.float64), row_ptr[:-1][full])
    return out.astype(np.float32)


@dataclass
class DeviceGraph:
    """The CSR on one device. Ids are int32; `row_ptr` is int64 because
    it is added to and used as an index on every walk hop."""

    row_ptr: torch.Tensor  # i64 [V+1]
    col_idx: torch.Tensor  # i32 [E]
    degree: torch.Tensor  # i32 [V]
    num_nodes: int
    edge_weight: torch.Tensor  # f32 [E]
    max_degree: int


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
        self._views = {}  # (name, device or None) -> view, see _view

        # opt-in sanitizer: every constructed graph is invariant-checked
        # when GE_TPU_VALIDATE is set
        if validation_enabled():
            validate_graph(self)

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

    def _view(self, name, device, build):
        """The view `name` on `device` (None: the host), built once. A card
        named without its index is the current one: 'cuda' and 'cuda:0'
        share one entry."""
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda" and device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        key = (name, None if device is None else str(device))
        if key not in self._views:
            self._views[key] = build()
        return self._views[key]

    def to(self, device) -> DeviceGraph:
        """The CSR as tensors on `device`, built once a device (callers do
        not write to them)."""
        return self._view("csr", device, lambda: DeviceGraph(
            row_ptr=torch.as_tensor(self.row_ptr.astype(np.int64),
                                    device=device),
            col_idx=torch.as_tensor(self.col_idx, device=device),
            degree=torch.as_tensor(self.degree, device=device),
            num_nodes=self.num_nodes,
            edge_weight=torch.as_tensor(self.edge_weight, device=device),
            max_degree=self.max_degree,
        ))

    def host_alias(self):
        """(accept f32[E], alias i32[E]): per-row alias tables aligned to
        the CSR, host numpy, built once."""
        return self._view("alias", None, lambda: build_row_alias(
            self.row_ptr, self.edge_weight))

    def alias_tables(self, device):
        """`host_alias()` as tensors on `device`, built once a device."""
        return self._view("alias", device, lambda: tuple(
            torch.as_tensor(t, device=device) for t in self.host_alias()))

    def weight_sums(self, device):
        """f32 [V] on `device`: each row's out-weight sum
        (`row_weight_sums`), built once a device."""
        return self._view("wsum", device, lambda: torch.as_tensor(
            row_weight_sums(self.row_ptr, self.edge_weight), device=device))

    @property
    def unit_weights(self) -> bool:
        """Whether every edge weighs 1."""
        return self._view("unit", None, lambda: bool(
            np.all(self.edge_weight == 1.0)))

    def _padded_rows(self, values, fill):
        """[V, max(max_degree, 1)] host array: row v holds `values` of
        v's out-edges in CSR order, then `fill`."""
        dmax = max(self.max_degree, 1)
        out = np.full((self.num_nodes, dmax), fill, dtype=values.dtype)
        # edge e of vertex v lands at row v, column e - row_ptr[v]
        deg = np.diff(self.row_ptr)
        rows = np.repeat(np.arange(self.num_nodes, dtype=np.int64), deg)
        cols = (np.arange(self.num_edges, dtype=np.int64)
                - np.repeat(self.row_ptr[:-1].astype(np.int64), deg))
        out[rows, cols] = values
        return out

    def neighbor_ids(self, device):
        """i32 [V, Dmax] on `device`: row v holds v's out-neighbors in
        ascending order, then -1; Dmax = max(max_degree, 1). Built once a
        device."""
        return self._view("ids", device, lambda: torch.as_tensor(
            self._padded_rows(self.col_idx, -1), device=device))

    def neighbor_matrix(self, device):
        """(`neighbor_ids`, f32 [V, Dmax] weights padded with 0) on
        `device`, each built once a device: dense-membership rejection
        reads only the ids, the exact sampler both."""
        return self.neighbor_ids(device), self._view(
            "weights", device, lambda: torch.as_tensor(
                self._padded_rows(self.edge_weight, 0.0), device=device))

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
