"""The benchmark's own count of a fit's work, from the cell's sizes alone:
nominal skip-gram pairs, model FLOPs, and the bytes the walk and the
trainer layers must move. Whatever implements a layer, these stay the
same, so a fused or replaced kernel leaves the rooflines standing.
"""

from __future__ import annotations

import json
import os

import numpy as np

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def peaks():
    """The card's published peaks (`peaks.json`)."""
    with open(PEAKS_FILE) as f:
        return json.load(f)


def pairs_per_walk(L: int, w: int) -> float:
    """Expected (center, context) pairs of one walk of L tokens under the
    reduced window b ~ U{1..w}: sum over d = 1..w of 2 (L - d) P(b >= d),
    P(b >= d) = (w - d + 1) / w."""
    return sum(2.0 * max(L - d, 0) * (w - d + 1) / w for d in range(1, w + 1))


def nominal_pairs(run_cfg: dict, V: int) -> float:
    """Pairs of one fit: num_walks * V walks, each epoch once."""
    return (run_cfg["num_walks"] * V * run_cfg["iter"]
            * pairs_per_walk(run_cfg["walk_length"], run_cfg["window_size"]))


def flops_per_pair(run_cfg: dict, mean_code_length: float | None) -> float:
    """Model FLOPs of a pair: a dot product, the gradient of each row and
    its update, 6 D a scored row; SGNS scores 1 + negative rows, hs=1 the
    pair's Huffman path (mean code length)."""
    D = run_cfg["embed_size"]
    if run_cfg["objective"] == "hs":
        if mean_code_length is None:
            return None
        return 6.0 * D * mean_code_length
    return 6.0 * D * (1 + run_cfg["negative"])


def train_bytes(run_cfg: dict, V: int) -> float:
    """Both tables ([V, D] input rows and [V, D] output or V - 1 inner-node
    rows, float32) read once and written once an epoch."""
    D = run_cfg["embed_size"]
    rows = V + (V - 1 if run_cfg["objective"] == "hs" else V)
    return 2.0 * rows * D * 4 * run_cfg["iter"]


def walk_bytes(run_cfg: dict, V: int, E: int) -> float:
    """The CSR read once (int32 row pointers and ids; the graph is
    unweighted, so it carries all a sampler needs) and the int32 corpus
    written once."""
    corpus = run_cfg["num_walks"] * V * run_cfg["walk_length"] * 4
    return 4.0 * (V + 1) + 4.0 * E + corpus


def mean_code_length(degrees: np.ndarray) -> float:
    """Mean Huffman code length under the uniform walk's stationary law
    (node weight = degree), the code built by the reference's own tree."""
    from gebench.reference.tables import huffman_code_lengths

    w = np.asarray(degrees, np.float64)
    lengths = huffman_code_lengths(np.maximum(w, 1e-9))
    return float((lengths * w).sum() / w.sum())
