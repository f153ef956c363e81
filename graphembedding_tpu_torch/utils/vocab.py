"""Node-name <-> integer-index vocabulary (numpy only).

Counterpart of `graphembedding_tpu/utils/vocab.py`: node names stay on the
host, everything on the device is an integer index. Indices follow
insertion order, which for `Graph.from_nx` is `graph.nodes()` order, as the
reference's `preprocess_nxgraph` assigns them.
"""

from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Tuple

import numpy as np


class Vocab:
    """Bidirectional node<->index mapping with stable insertion order."""

    __slots__ = ("idx2node", "node2idx")

    def __init__(self, nodes: Iterable[Hashable] = ()):
        self.idx2node: List[Hashable] = []
        self.node2idx: Dict[Hashable, int] = {}
        for n in nodes:
            self.add(n)

    def add(self, node: Hashable) -> int:
        idx = self.node2idx.get(node)
        if idx is None:
            idx = len(self.idx2node)
            self.node2idx[node] = idx
            self.idx2node.append(node)
        return idx

    def __len__(self) -> int:
        return len(self.idx2node)

    def __contains__(self, node: Hashable) -> bool:
        return node in self.node2idx

    def __getitem__(self, node: Hashable) -> int:
        return self.node2idx[node]

    def names(self, indices: Iterable[int]) -> List[Hashable]:
        return [self.idx2node[i] for i in indices]


class IdentityVocab:
    """Lazy vocabulary where node i IS index i.

    The default for integer graphs built without names: `idx2node` is a
    `range` and `node2idx` is the vocab itself, so lookups behave like
    `Vocab` without materialising a dict of every node.
    """

    __slots__ = ("idx2node",)

    def __init__(self, num_nodes: int):
        self.idx2node = range(num_nodes)

    @property
    def node2idx(self) -> "IdentityVocab":
        return self

    def __len__(self) -> int:
        return len(self.idx2node)

    @staticmethod
    def _as_index(node):
        if isinstance(node, bool) or not isinstance(node, (int, np.integer)):
            return None
        return int(node)

    def __contains__(self, node) -> bool:
        i = self._as_index(node)
        return i is not None and 0 <= i < len(self.idx2node)

    def __getitem__(self, node) -> int:
        if node not in self:
            raise KeyError(node)
        return int(node)

    def add(self, node) -> int:
        """A fixed-size vocabulary: a known id returns itself, any other
        node raises KeyError."""
        if node not in self:
            raise KeyError(
                f"IdentityVocab({len(self.idx2node)}) cannot add {node!r}")
        return int(node)

    def names(self, indices: Iterable[int]) -> List:
        """The ids themselves; IndexError for one outside [0, V)."""
        n = len(self.idx2node)
        out = []
        for i in indices:
            if not 0 <= i < n:
                raise IndexError(i)
            out.append(int(i))
        return out


def preprocess_nxgraph(graph) -> Tuple[List, Dict]:
    """Reference-API shim: (idx2node, node2idx) in graph.nodes() order."""
    vocab = Vocab(graph.nodes())
    return vocab.idx2node, vocab.node2idx


# the reference's work-partition helpers (`ge/utils.py`, partition_*): they
# sliced work for joblib processes; here all parallelism is on the device,
# and they are kept for users' migration scripts


def partition_num(num: int, workers: int) -> List[int]:
    if num % workers == 0:
        return [num // workers] * workers
    return [num // workers] * workers + [num % workers]


def partition_dict(vertices: Dict, workers: int):
    batch_size = (len(vertices) - 1) // workers + 1
    part_list, part = [], []
    for v1, nbs in vertices.items():
        part.append((v1, nbs))
        if len(part) == batch_size:
            part_list.append(part)
            part = []
    if part:
        part_list.append(part)
    return part_list


def partition_list(vertices: List, workers: int):
    batch_size = (len(vertices) - 1) // workers + 1
    part_list, part = [], []
    for v1, nbs in enumerate(vertices):
        part.append((v1, nbs))
        if len(part) == batch_size:
            part_list.append(part)
            part = []
    if part:
        part_list.append(part)
    return part_list
