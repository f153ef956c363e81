"""Embedding table import/export.

The reference returns embeddings only as an in-memory dict
(`ge/models/* — get_embeddings [U]`); persisting them means going
through gensim's `wv.save_word2vec_format`. We provide the same
interchange surface natively: the word2vec text format (readable by
gensim, fastText, and every downstream eval script in this literature)
plus a lossless `.npz` form for round-tripping float32 exactly.

Word2vec text format: a header line ``"<count> <dim>"`` followed by one
``"<token> <v_0> ... <v_{dim-1}>"`` line per node. Tokens containing
whitespace are rejected at save time (the format cannot represent
them); use the npz form for arbitrary node names.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def save_word2vec_format(embeddings: Dict, path: str) -> None:
    """Write ``{node: vector}`` as word2vec text (gensim-compatible).

    All names/dims are validated BEFORE anything is written, and the
    file is written via a temp + atomic rename — a raised ValueError
    never leaves a truncated artifact behind.
    """
    if not embeddings:
        raise ValueError("empty embeddings dict")
    items = []
    dim = int(np.asarray(next(iter(embeddings.values()))).shape[-1])
    for node, vec in embeddings.items():
        tok = str(node)
        if any(c.isspace() for c in tok):
            raise ValueError(
                f"node name {tok!r} contains whitespace; the word2vec "
                "text format cannot represent it — use save_npz"
            )
        v = np.asarray(vec, dtype=np.float32).ravel()
        if v.shape[0] != dim:
            raise ValueError(
                f"node {tok!r} has dim {v.shape[0]}, expected {dim}"
            )
        items.append((tok, v))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(f"{len(items)} {dim}\n")
        for tok, v in items:
            f.write(tok + " " + " ".join(repr(float(x)) for x in v) + "\n")
    os.replace(tmp, path)


def load_word2vec_format(path: str) -> Dict[str, np.ndarray]:
    """Read word2vec text written by us or by gensim (text mode)."""
    out: Dict[str, np.ndarray] = {}
    with open(path) as f:
        header = f.readline().split()
        count, dim = int(header[0]), int(header[1])
        for line in f:
            parts = line.rstrip("\n").split(" ")
            tok, vals = parts[0], parts[1:]
            if len(vals) != dim:
                raise ValueError(
                    f"malformed line for {tok!r}: {len(vals)} values, "
                    f"expected {dim}"
                )
            out[tok] = np.asarray(vals, dtype=np.float32)
    if len(out) != count:
        raise ValueError(f"header said {count} rows, file had {len(out)}")
    return out


def save_npz(embeddings: Dict, path: str) -> None:
    """Lossless float32 save with arbitrary (string) node names."""
    nodes = list(embeddings.keys())
    table = np.stack(
        [np.asarray(embeddings[n], dtype=np.float32) for n in nodes]
    )
    np.savez_compressed(
        path, nodes=np.asarray([str(n) for n in nodes]), table=table
    )


def load_npz(path: str) -> Dict[str, np.ndarray]:
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"  # np.savez appends the suffix
    with np.load(path, allow_pickle=False) as z:
        nodes, table = z["nodes"], z["table"]
    return {str(n): table[i] for i, n in enumerate(nodes)}
