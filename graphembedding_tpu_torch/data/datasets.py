"""Wiki and flight dataset loaders and their synthetic stand-ins (numpy
only).

Counterpart of `graphembedding_tpu/data/datasets.py` for Wiki and the
flight networks. `load_dataset('wiki')` reads the reference's files
(`wiki/Wiki_edgelist.txt`, `wiki/wiki_labels.txt`) and
`load_dataset('flight-<region>')` the region's
(`flight/<region>-airports.edgelist`, `flight/labels-<region>-airports.txt`)
from the directory named by `GE_TPU_REFERENCE_ROOT` (its `data/` folder) or
from this package's `data/files/`; otherwise each generates its synthetic
graph at the real node count. Nothing is downloaded. The generators draw
from numpy's `default_rng` in the same order as the JAX package's, so a
seed gives the same CSR and labels in both packages.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from graphembedding_tpu_torch.eval.classify import read_node_label
from graphembedding_tpu_torch.graph import Graph
from graphembedding_tpu_torch.utils.vocab import Vocab


@dataclass
class Dataset:
    name: str
    graph: Graph
    labels: Dict[str, List[str]]  # node name -> label list
    synthetic: bool = False

    @property
    def X(self):
        return list(self.labels.keys())

    @property
    def Y(self):
        return [self.labels[x] for x in self.X]


def _find(*relpaths) -> Optional[str]:
    dirs = [os.path.join(os.path.dirname(__file__), "files")]
    env_root = os.environ.get("GE_TPU_REFERENCE_ROOT")
    if env_root:
        dirs.insert(0, os.path.join(env_root, "data"))
    for d in dirs:
        for rel in relpaths:
            p = os.path.join(d, rel)
            if os.path.exists(p):
                return p
    return None


def _labels_from_file(path) -> Dict[str, List[str]]:
    with open(path) as f:
        first = f.readline().split()
    skip = bool(first) and first[0].lower() == "node"
    X, Y = read_node_label(path, skip_head=skip)
    return dict(zip(X, Y))


def synthetic_wiki(
    num_nodes: int = 2405,
    num_classes: int = 17,
    avg_degree: float = 7.5,
    p_in: float = 0.75,
    seed: int = 7,
) -> Dataset:
    """Degree-corrected SBM at Wiki scale; labels are the planted
    communities. Directed, integer weights in {1..3}."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, num_classes, size=num_nodes)
    theta = rng.pareto(2.5, size=num_nodes) + 0.25
    theta /= theta.mean()

    n_edges = int(num_nodes * avg_degree)
    src = rng.choice(num_nodes, size=n_edges, p=theta / theta.sum())
    dst = np.empty(n_edges, dtype=np.int64)
    in_comm = rng.random(n_edges) < p_in
    members = [np.where(comm == c)[0] for c in range(num_classes)]
    probs = [theta[m] / theta[m].sum() for m in members]
    global_p = theta / theta.sum()
    for c in range(num_classes):
        sel = in_comm & (comm[src] == c)
        k = int(sel.sum())
        if k:
            dst[sel] = rng.choice(members[c], size=k, p=probs[c])
    k_out = int((~in_comm).sum())
    if k_out:
        dst[~in_comm] = rng.choice(num_nodes, size=k_out, p=global_p)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    uniq = np.unique(src * num_nodes + dst)
    src, dst = uniq // num_nodes, uniq % num_nodes
    w = rng.integers(1, 4, size=src.shape[0]).astype(np.float32)

    vocab = Vocab(str(i) for i in range(num_nodes))
    graph = Graph(src, dst, w, num_nodes=num_nodes, vocab=vocab,
                  directed=True)
    labels = {str(i): [str(comm[i])] for i in range(num_nodes)}
    return Dataset("wiki-synthetic", graph, labels, synthetic=True)


def synthetic_wiki_hard(
    num_nodes: int = 600,
    num_classes: int = 6,
    avg_degree: float = 8.0,
    p_in: float = 0.45,
    seed: int = 7,
) -> Dataset:
    """SBM near the detectability threshold: micro-F1 lands in a 0.6-0.8
    band where a quality regression of a few points shows."""
    base = synthetic_wiki(num_nodes=num_nodes, num_classes=num_classes,
                          avg_degree=avg_degree, p_in=p_in, seed=seed)
    return Dataset("wiki-synthetic-hard", base.graph, base.labels,
                   synthetic=True)


def _degree_quartiles(degree) -> np.ndarray:
    """Each node's degree quartile, 0-3: the flight networks' activity
    labels."""
    return np.searchsorted(np.quantile(degree, [0.25, 0.5, 0.75]), degree,
                           side="right")


def synthetic_flight(num_nodes: int = 131, seed: int = 11) -> Dataset:
    """Hub-and-spoke airport-like network (preferential attachment, m = 3,
    undirected); labels are degree quartiles, a structural role rather
    than a community."""
    rng = np.random.default_rng(seed)
    m = 3
    src_l, dst_l = [], []
    targets = list(range(m))
    repeated: List[int] = list(range(m))
    for v in range(m, num_nodes):
        for t in set(targets):
            src_l.append(v)
            dst_l.append(t)
            repeated.extend([v, t])
        targets = [repeated[rng.integers(0, len(repeated))] for _ in range(m)]

    vocab = Vocab(str(i) for i in range(num_nodes))
    graph = Graph(np.array(src_l), np.array(dst_l), None, num_nodes=num_nodes,
                  vocab=vocab, directed=False)
    quart = _degree_quartiles(graph.degree)
    labels = {str(i): [str(quart[i])] for i in range(num_nodes)}
    return Dataset("flight-synthetic", graph, labels, synthetic=True)


def synthetic_flight_hard(num_nodes: int = 200, seed: int = 11,
                          flip: float = 0.35) -> Dataset:
    """`synthetic_flight` with a seeded `flip` fraction of nodes given a
    random other quartile, which caps micro-F1 near 0.65: a band where a
    quality regression of a few points shows."""
    base = synthetic_flight(num_nodes=num_nodes, seed=seed)
    quart = _degree_quartiles(base.graph.degree)
    rng = np.random.default_rng(seed + 1)
    flip_mask = rng.random(num_nodes) < flip
    offs = rng.integers(1, 4, size=num_nodes)
    noisy = np.where(flip_mask, (quart + offs) % 4, quart)
    labels = {str(i): [str(noisy[i])] for i in range(num_nodes)}
    return Dataset("flight-synthetic-hard", base.graph, labels,
                   synthetic=True)


# the regions' real node counts, which their synthetic stand-ins take
FLIGHT_SIZES = {"brazil": 131, "europe": 399, "usa": 1190}


def load_dataset(name: str) -> Dataset:
    """Load a named dataset: real files if present, synthetic otherwise.

    Names: 'wiki', 'flight-brazil', 'flight-europe', 'flight-usa' ('flight'
    alone is Brazil). Other names raise NotImplementedError.
    """
    name = name.lower()
    if name == "wiki":
        edges = _find("wiki/Wiki_edgelist.txt")
        labels = _find("wiki/wiki_labels.txt", "wiki/Wiki_labels.txt")
        if edges and labels:
            g = Graph.from_edgelist(edges, directed=True, weighted=True)
            return Dataset("wiki", g, _labels_from_file(labels))
        return synthetic_wiki()
    if name.startswith("flight"):
        region = name.split("-")[-1] if "-" in name else "brazil"
        edges = _find(f"flight/{region}-airports.edgelist")
        labels = _find(f"flight/labels-{region}-airports.txt")
        if edges and labels:
            g = Graph.from_edgelist(edges, directed=False, weighted=False)
            return Dataset(name, g, _labels_from_file(labels))
        return synthetic_flight(num_nodes=FLIGHT_SIZES.get(region, 131))
    raise NotImplementedError(
        f"dataset {name!r} is not ported to graphembedding_tpu_torch")
