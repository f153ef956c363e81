"""The comparison that decides a run's `correct`.

A sampled fit of the window is judged by what it produced, after the
window has closed, by its model module's `judge` (`gebench/models/`)
against the plain reference: {name: value}, the names the module's
`CHECKS`. Each limit is in the cell's file (`cells/<workload>.json`), set
from the readings in PERF.md; `harness.load_cell` refuses a cell that
lacks one.
"""

from __future__ import annotations

import numpy as np


def verdict(values: dict, limits: dict, names):
    """(correct, {name: {"value", "limit"}}) over `names`: every value at
    or under its limit (a NaN fails)."""
    shown = {}
    ok = True
    for name in names:
        v = values.get(name)
        lim = limits[name]
        good = v is not None and bool(np.isfinite(v)) and v <= lim
        ok = ok and good
        # a value that is not finite shows as null: JSON has no infinity
        shown[name] = {"value": float(v) if good or (
            v is not None and np.isfinite(v)) else None, "limit": lim}
    return ok, shown
