"""Alias-method tables (Walker's alias method): numpy construction, torch
draws.

Counterpart of `graphembedding_tpu/ops/alias.py`: the O(n) construction,
the per-row tables over a CSR (`build_row_alias`, the JAX package's numpy
loop; the port has no native builder) and the reference-signature shims,
bit-equal to the JAX package's. A draw on the device is two uniforms and
two gathers:

    pick = floor(u1 * n); out = where(u2 < accept[pick], pick, alias[pick])

`alias_draw` makes it from flat per-row tables for the weighted and
rejection walks (bit-equal to the JAX `alias_draw` on the same uniforms);
LINE's edge sampler writes it out over one table (`models/line.py`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def build_alias_table(probs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Build (accept, alias) for one categorical distribution.

    `probs` need not be normalized. Returns accept (f32[n]) and alias
    (i32[n], local indices). Empty input returns empty tables.
    """
    probs = np.asarray(probs, dtype=np.float64)
    n = probs.shape[0]
    if n == 0:
        return np.zeros(0, np.float32), np.zeros(0, np.int32)
    total = probs.sum()
    area = np.ones(n, dtype=np.float64) if total <= 0 else probs * (n / total)

    accept = np.zeros(n, dtype=np.float64)
    alias = np.zeros(n, dtype=np.int32)
    small = [i for i in range(n) if area[i] < 1.0]
    large = [i for i in range(n) if area[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        accept[s] = area[s]
        alias[s] = l
        area[l] = area[l] - (1.0 - area[s])
        if area[l] < 1.0:
            small.append(l)
        else:
            large.append(l)
    # what is left over is 1 up to rounding
    for i in large + small:
        accept[i] = 1.0
    return accept.astype(np.float32), alias


def build_row_alias(row_ptr: np.ndarray,
                    weights: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row alias tables over a CSR weight array, aligned to it: row v's
    slots are row_ptr[v]:row_ptr[v + 1], and `alias` holds indices local
    to the row. Returns accept (f32[E]) and alias (i32[E])."""
    accept = np.ones(weights.shape[0], dtype=np.float32)
    alias = np.zeros(weights.shape[0], dtype=np.int32)
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    # a row of unit weights builds to accept 1, alias 0 (every area is
    # exactly 1), which the tables already hold: loop over the others only
    full = np.flatnonzero(np.diff(row_ptr) > 0)
    if full.size:
        weighted = np.logical_or.reduceat(weights != 1.0, row_ptr[full])
        for v in full[weighted]:
            s, e = int(row_ptr[v]), int(row_ptr[v + 1])
            accept[s:e], alias[s:e] = build_alias_table(weights[s:e])
    return accept, alias


def alias_draw(accept, alias, offsets, sizes, u1, u2):
    """Slots drawn from flat per-row alias tables (torch, any batch shape).

    offsets: int, each row's start in the tables (row_ptr[v]); sizes: int,
    each row's length, at least 1; u1, u2: f32 uniforms in [0, 1). Returns
    the local slot, in [0, sizes), with the dtype of `alias`. A read at an
    offset past the tables' end (a row of degree 0 at row_ptr == E, drawn
    with size 1) is clamped to the last slot; callers mask those draws.
    """
    pick = torch.minimum((u1 * sizes.to(torch.float32)).to(sizes.dtype),
                         sizes - 1)
    flat = (offsets + pick).clamp(max=accept.shape[0] - 1)
    take = u2 < accept[flat]
    return torch.where(take, pick.to(alias.dtype), alias[flat])


def create_alias_table(area_ratio) -> Tuple[list, list]:
    """Reference signature (`ge.alias.create_alias_table`): (accept,
    alias) as Python lists."""
    accept, alias = build_alias_table(np.asarray(area_ratio))
    return accept.tolist(), alias.tolist()


def alias_sample(accept, alias) -> int:
    """Reference signature (`ge.alias.alias_sample`): one draw from
    numpy's global random state."""
    n = len(accept)
    i = int(np.random.random() * n)
    return i if np.random.random() < accept[i] else int(alias[i])


def alias_sample_host(accept: np.ndarray, alias: np.ndarray,
                      rng: np.random.Generator, size=None):
    """Host draw(s) from one alias table."""
    n = accept.shape[0]
    pick = rng.integers(0, n, size=size)
    u = rng.random(size=size)
    return np.where(u < accept[pick], pick, alias[pick])
