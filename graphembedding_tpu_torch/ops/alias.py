"""Alias-method tables (Walker's alias method), host side, numpy only.

Counterpart of the host half of `graphembedding_tpu/ops/alias.py`: the
O(n) construction and the reference-signature shims, bit-equal to the JAX
package's. A draw on the device is two uniforms and two gathers:

    pick = floor(u1 * n); out = where(u2 < accept[pick], pick, alias[pick])

which LINE's edge sampler writes out in torch (`models/line.py`). The
per-row tables of weighted walks (`build_row_alias`, `alias_draw`) are not
ported yet.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
