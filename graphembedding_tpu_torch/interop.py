"""Embedding tables between the JAX package's layout and the port's.

The JAX package keeps `w_in` and `w_out` as two [V, D] arrays at its API;
the port's walk models train one fused [V, 2D] table. LINE keeps the same
three [V, D] tables in both packages, and the hierarchical-softmax trainer
the same w_in [V, D] and w_tree [max(V - 1, 1), D]. SDNE's parameters are a
pytree {"enc": [{"w", "b"}, ...], "dec": [...]} in the JAX package and an
`nn.Module` state here, with every `w` in the same [in, out] orientation
(`x @ w + b`), so no weight is transposed. The functions take and give
numpy-convertible arrays, so the port never imports jax: `np.asarray`
reads a JAX array without it.
"""

from __future__ import annotations

import numpy as np
import torch


def tables_from_jax(w_in, w_out) -> torch.Tensor:
    """[V, D] w_in and w_out -> fused float32 [V, 2D] CPU table."""
    return torch.from_numpy(np.concatenate(
        [np.asarray(w_in, dtype=np.float32),
         np.asarray(w_out, dtype=np.float32)], axis=1))


def tables_to_numpy(w_cat):
    """Fused [V, 2D] table -> (w_in, w_out) float32 numpy arrays."""
    a = w_cat.detach().cpu().numpy()
    D = a.shape[1] // 2
    return a[:, :D].copy(), a[:, D:].copy()


def rowshard_tables_from_jax(w_cat, n):
    """The JAX package's padded [n * Vp, 2D] row-sharded table -> the n
    ranks' float32 CPU shards, rank r's rows [r * Vp, (r + 1) * Vp)."""
    a = np.asarray(w_cat, dtype=np.float32)
    if a.shape[0] % n:
        raise ValueError(f"{a.shape[0]} rows do not split over {n} ranks")
    return [torch.from_numpy(p.copy()) for p in np.split(a, n)]


def rowshard_tables_to_numpy(shards):
    """The ranks' [Vp, 2D] shards, in rank order -> the padded [n * Vp, 2D]
    float32 numpy table of the JAX package's layout."""
    return np.concatenate([np.asarray(
        s.detach().cpu().numpy() if isinstance(s, torch.Tensor) else s,
        dtype=np.float32) for s in shards])


def line_tables_from_jax(first_emb, second_emb, context_emb):
    """A JAX `LINE`'s first_emb, second_emb and context_emb -> three
    float32 CPU tensors, to assign to the port's `LINE` of the same name
    (move them to its device first)."""
    return tuple(torch.from_numpy(np.array(t, dtype=np.float32))
                 for t in (first_emb, second_emb, context_emb))


def hs_tables_from_jax(w_in, w_tree):
    """The JAX package's hierarchical-softmax tables w_in [V, D] and w_tree
    [max(V - 1, 1), D] -> two float32 CPU tensors (move them to the
    port's device first)."""
    return tuple(torch.from_numpy(np.array(t, dtype=np.float32))
                 for t in (w_in, w_tree))


def sdne_params_from_jax(params):
    """A JAX `SDNE.params` pytree {"enc": [{"w": [in, out], "b": [out]},
    ...], "dec": [...]} -> a float32 CPU state dict for the port's
    `SDNE.net.load_state_dict` (keys "enc.0.w", "enc.0.b", ...)."""
    return {f"{stack}.{i}.{k}": torch.from_numpy(
                np.array(layer[k], dtype=np.float32))
            for stack in ("enc", "dec")
            for i, layer in enumerate(params[stack]) for k in ("w", "b")}


def sdne_params_to_numpy(net):
    """The port's SDNE autoencoder (`SDNE.net`) -> the JAX package's
    pytree layout, float32 numpy arrays."""
    return {stack: [{"w": layer.w.detach().cpu().numpy(),
                     "b": layer.b.detach().cpu().numpy()}
                    for layer in getattr(net, stack)]
            for stack in ("enc", "dec")}
