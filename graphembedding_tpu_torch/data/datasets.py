"""Wiki dataset loader and its synthetic stand-ins (numpy only).

Counterpart of `graphembedding_tpu/data/datasets.py` for the graphs the
DeepWalk-on-Wiki slice needs. `load_dataset('wiki')` reads the reference's
files (`wiki/Wiki_edgelist.txt`, `wiki/wiki_labels.txt`) from the
directory named by `GE_TPU_REFERENCE_ROOT` (its `data/` folder) or from
this package's `data/files/`; otherwise it generates the synthetic
Wiki-scale graph. The generators draw from numpy's `default_rng` in the
same order as the JAX package's, so a seed gives the same CSR and labels
in both packages.
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


def load_dataset(name: str) -> Dataset:
    """Load a named dataset: real files if present, synthetic otherwise.

    Only 'wiki' is ported; other names raise NotImplementedError.
    """
    name = name.lower()
    if name != "wiki":
        raise NotImplementedError(
            f"dataset {name!r} is not ported to graphembedding_tpu_torch")
    edges = _find("wiki/Wiki_edgelist.txt")
    labels = _find("wiki/wiki_labels.txt", "wiki/Wiki_labels.txt")
    if edges and labels:
        g = Graph.from_edgelist(edges, directed=True, weighted=True)
        return Dataset("wiki", g, _labels_from_file(labels))
    return synthetic_wiki()
