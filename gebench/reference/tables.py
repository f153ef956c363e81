"""What a fit derives from its corpus, worked out again in plain NumPy:
node counts, word2vec's unigram^0.75 negative table, the subsample keep
probabilities and the Huffman code of hierarchical softmax.

Each follows the published rule (word2vec / gensim), in float64 on the
host, so that the table and the tree are fixed by the corpus alone.
"""

from __future__ import annotations

import numpy as np
import torch


def corpus_counts(walks: torch.Tensor, num_nodes: int) -> np.ndarray:
    """float64 [V]: how often each node occurs in the corpus (-1 pads
    left out)."""
    ids = walks.reshape(-1)
    ids = ids[ids >= 0].long()
    return torch.bincount(ids, minlength=num_nodes).cpu().numpy().astype(
        np.float64)


def negative_table(counts: np.ndarray, exponent: float,
                   size: int) -> np.ndarray:
    """int32 [size]: slot j holds the node whose share of the cumulative
    counts^exponent first reaches (j + 0.5) / size."""
    weight = np.power(np.maximum(counts, 0.0), exponent)
    if weight.sum() <= 0:
        weight = np.ones_like(weight)
    cum = np.cumsum(weight) / weight.sum()
    targets = (np.arange(size) + 0.5) / size
    return np.searchsorted(cum, targets, side="left").astype(np.int32)


def keep_probs(counts: np.ndarray, sample: float) -> np.ndarray:
    """float32 [V]: word2vec's keep probability (sqrt(f / sample) + 1) *
    sample / f of a node of corpus frequency f, at most 1; 0 for a node
    that never occurs."""
    f = counts / max(float(counts.sum()), 1.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        p = (np.sqrt(f / sample) + 1.0) * (sample / f)
    return np.where(f > 0, np.minimum(p, 1.0), 0.0).astype(np.float32)


def huffman_merges(weights: np.ndarray):
    """The merges of a Huffman tree over `weights` (float64 [V], V >= 2):
    (first [V - 1], second [V - 1]) node ids, merge k making inner node
    V + k. Each merge takes the two lightest nodes, the lower id first on
    equal weight (word2vec's heap of (count, id)); the leaves sorted by
    (weight, id) and the inner nodes in the order they are made are two
    queues whose heads are those two nodes."""
    V = weights.shape[0]
    order = np.argsort(weights, kind="stable")
    leaf_w = weights[order].tolist() + [np.inf]
    leaf_id = order.tolist()
    inner_w = [np.inf] * (V - 1)
    first = [0] * (V - 1)
    second = [0] * (V - 1)
    i = j = 0
    for k in range(V - 1):
        picked = []
        for _ in range(2):
            if leaf_w[i] <= inner_w[j]:
                picked.append((leaf_w[i], leaf_id[i]))
                i += 1
            else:
                picked.append((inner_w[j], V + j))
                j += 1
        (wa, a), (wb, b) = picked
        inner_w[k] = wa + wb
        first[k], second[k] = a, b
    return np.asarray(first, np.int64), np.asarray(second, np.int64)


def huffman_code(counts: np.ndarray):
    """(points int32 [V, T], codes float32 [V, T]) of the Huffman tree over
    max(counts, 1e-9): row v lists the inner nodes (ids 0 .. V - 2, merge
    order) from the root down to leaf v, -1 after its end, and the branch
    taken at each (0 toward a merge's first node, 1 toward its second)."""
    V = counts.shape[0]
    if V == 1:
        return np.full((1, 1), -1, np.int32), np.zeros((1, 1), np.float32)
    first, second = huffman_merges(np.maximum(counts.astype(np.float64),
                                              1e-9))
    parent = np.full(2 * V - 1, -1, np.int64)
    bit = np.zeros(2 * V - 1, np.int8)
    inner = np.arange(V - 1) + V
    parent[first], parent[second] = inner, inner
    bit[second] = 1
    # climb from every leaf at once, recording (inner id, branch) leaf-up
    up_pts, up_bits = [], []
    cur = np.arange(V)
    length = np.zeros(V, np.int64)
    while True:
        live = parent[cur] >= 0
        if not live.any():
            break
        up_pts.append(np.where(live, parent[cur] - V, -1))
        up_bits.append(np.where(live, bit[cur], 0))
        length += live
        cur = np.where(live, parent[cur], cur)
    T = max(len(up_pts), 1)
    up_pts = np.stack(up_pts, 1)
    up_bits = np.stack(up_bits, 1)
    points = np.full((V, T), -1, np.int32)
    codes = np.zeros((V, T), np.float32)
    rows, cols = np.nonzero(np.arange(T)[None, :] < length[:, None])
    root_first = length[rows] - 1 - cols
    points[rows, root_first] = up_pts[rows, cols]
    codes[rows, root_first] = up_bits[rows, cols]
    return points, codes


def huffman_code_lengths(weights: np.ndarray) -> np.ndarray:
    """int64 [V]: each node's code length in the Huffman tree over
    `weights` (float64, V >= 2)."""
    V = weights.shape[0]
    first, second = huffman_merges(weights.astype(np.float64))
    depth = np.zeros(2 * V - 1, np.int64)
    # a node is made before its parent: walk the merges from the root down
    for k in range(V - 2, -1, -1):
        depth[first[k]] = depth[second[k]] = depth[V + k] + 1
    return depth[:V]
