"""Embedding similarity queries (the gensim `wv.most_similar` role).

Counterpart of `graphembedding_tpu/utils/simquery.py`. `get_embeddings()`
returns a plain dict, so the query surface of gensim's KeyedVectors is
reproduced here for migrating code:

    emb = model.get_embeddings()
    most_similar(emb, "42", topn=10)   # [(node, cosine), ...]

Small vocabularies run in numpy, exactly as the JAX package does. From
`_DEVICE_MIN_ROWS` rows up, one `torch.matmul` of the [V, D] table by the
query and one `torch.topk` run on `device` (the card by default; the JAX
package computes the same plain product outside Pallas).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

# past this row count, scoring moves to the device (one product + top-k);
# below it numpy wins on dispatch overhead
_DEVICE_MIN_ROWS = 200_000

# the device copy of the last (names, matrix) pair's matrix and its row
# norms: (weak reference to the host matrix, device, table, norms). Repeated
# queries on the same pair upload it once; the entry is dropped when the
# host matrix is freed. A matrix changed in place after a query is not seen:
# pass a new array.
_device_tables = {}


def _as_table(embeddings):
    """dict {node: vec} -> (names list, [V, D] f32 matrix)."""
    if isinstance(embeddings, dict):
        names = list(embeddings.keys())
        table = np.asarray(
            [embeddings[n] for n in names], dtype=np.float32
        )
        return names, table
    names, table = embeddings  # (names, matrix) pair
    return list(names), np.asarray(table, dtype=np.float32)


def _device_table(table, device, cache):
    """(table, row norms) on device; cached for the pair form."""
    hit = _device_tables.get("last")
    if cache and hit and hit[0]() is table and hit[1] == device:
        return hit[2], hit[3]
    # a copy even on the CPU: a tensor sharing the host matrix's memory
    # would keep it alive, and the cache entry with it
    tab = torch.tensor(table, device=device)
    norms = torch.linalg.vector_norm(tab, dim=1)
    if cache:
        _device_tables["last"] = (
            weakref.ref(table, lambda _: _device_tables.clear()), device,
            tab, norms)
    return tab, norms


def _device_score(table, q, qn, k, device, cache):
    """Top-k of cosine(table rows, q) on `device`: (values, indices) as
    numpy arrays."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"most_similar on {table.shape[0]} rows runs on {str(device)!r}, "
            "but torch sees no CUDA card; pass device='cpu'")
    tab, norms = _device_table(table, device, cache)
    qd = torch.as_tensor(q, device=device)
    denom = (norms * max(qn, 1e-12)).clamp(min=1e-12)
    vals, idx = torch.topk(torch.matmul(tab, qd) / denom, k)
    return vals.cpu().numpy(), idx.cpu().numpy()


def most_similar(embeddings, node=None, vector=None, topn=10,
                 device="cuda"):
    """Top-`topn` cosine neighbors of `node` (or a raw `vector`).

    `embeddings`: the models' `get_embeddings()` dict, or a
    `(names, [V, D] matrix)` pair: pass the PAIR for repeated queries at
    scale (the dict form rebuilds the matrix per call; the pair form reuses
    it, and its device copy is cached across calls). Returns
    [(name, score), ...] in descending cosine similarity, excluding the
    query node itself. `device` scores tables of `_DEVICE_MIN_ROWS` rows
    or more; where it names a CUDA device and there is no card, that
    raises unless the caller passes device='cpu'.
    """
    if (node is None) == (vector is None):
        raise ValueError("pass exactly one of node= or vector=")
    names, table = _as_table(embeddings)
    if node is not None:
        try:
            qi = names.index(node)
        except ValueError:
            raise KeyError(f"unknown node {node!r}") from None
        q = table[qi]
    else:
        qi = -1
        q = np.asarray(vector, dtype=np.float32)
    qn = np.linalg.norm(q)

    k = min(topn + (1 if qi >= 0 else 0), table.shape[0])
    if table.shape[0] >= _DEVICE_MIN_ROWS:
        vals, idx = _device_score(table, q, float(qn), k, device,
                                  cache=not isinstance(embeddings, dict))
    else:
        norms = np.linalg.norm(table, axis=1)
        denom = np.maximum(norms * max(qn, 1e-12), 1e-12)
        sims = (table @ q) / denom
        idx = np.argpartition(-sims, min(k, sims.shape[0] - 1))[:k]
        idx = idx[np.argsort(-sims[idx])]
        vals = sims[idx]
    out = [
        (names[i], float(v)) for i, v in zip(idx, vals) if i != qi
    ]
    return out[:topn]


def similarity(embeddings, a, b):
    """Cosine similarity between two nodes (gensim `wv.similarity`)."""
    names, table = _as_table(embeddings)
    try:
        ia, ib = names.index(a), names.index(b)
    except ValueError as e:  # match most_similar's (and gensim's)
        raise KeyError(str(e)) from None
    va, vb = table[ia], table[ib]
    return float(
        va @ vb
        / max(np.linalg.norm(va) * np.linalg.norm(vb), 1e-12)
    )
