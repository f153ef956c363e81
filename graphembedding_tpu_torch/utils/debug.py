"""Runtime validation harness: host-side invariant checks and NaN guards.

Counterpart of `graphembedding_tpu/utils/debug.py`. Out-of-range indices
and NaN/Inf escaping into the tables are what silently corrupt a run:

- :func:`validate_graph` / :func:`validate_walks`: host-side structural
  invariants for CSR graphs and walk corpora (vectorized numpy, exact),
  raising ``ValueError`` naming the first violated invariant; the same
  checks, and the same opt-in gate (`GE_TPU_VALIDATE`), as the JAX
  package's. `Graph` runs `validate_graph` at construction and the
  trainers run `validate_walks` when the gate is set;
- :func:`checked`: runs a function and raises when a floating output
  holds a NaN or an Inf. Eager PyTorch already raises on an out-of-range
  index, which is what `checkify`'s index checks add in the JAX package;
- :func:`debug_guard`: a context that turns on
  `torch.autograd.set_detect_anomaly` and restores it afterwards.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import numpy as np
import torch


def validation_enabled() -> bool:
    """Single home for the GE_TPU_VALIDATE opt-in gate.

    Read at each call site (not import time) so tests and long-lived
    processes can toggle validation without reimporting.
    """
    return bool(os.environ.get("GE_TPU_VALIDATE"))


def validate_graph(g) -> None:
    """Check the CSR invariants every walk/train kernel relies on.

    Raises ValueError on the first violation. Invariants:
    row_ptr is a [V+1] nondecreasing int array starting at 0 and ending
    at num_edges; degree == diff(row_ptr); col_idx values are vertex ids
    in [0, V); columns are sorted within each row (the rejection-sampling
    (p,q) walk binary-searches them); edge weights are finite and >= 0.
    """
    V, E = g.num_nodes, g.num_edges
    rp = np.asarray(g.row_ptr)
    ci = np.asarray(g.col_idx)
    w = np.asarray(g.edge_weight)
    deg = np.asarray(g.degree)

    if rp.shape != (V + 1,):
        raise ValueError(f"row_ptr shape {rp.shape} != ({V + 1},)")
    if rp[0] != 0 or rp[-1] != E:
        raise ValueError(
            f"row_ptr endpoints ({rp[0]}, {rp[-1]}) != (0, {E})"
        )
    d = np.diff(rp)
    if (d < 0).any():
        r = int(np.argmax(d < 0))
        raise ValueError(f"row_ptr decreases at row {r}")
    if deg.shape != (V,) or (d != deg).any():
        raise ValueError("degree != diff(row_ptr)")
    if ci.shape[0] != E:
        raise ValueError(f"col_idx has {ci.shape[0]} entries != E={E}")
    if E and (bad := (ci < 0) | (ci >= V)).any():
        i = int(np.argmax(bad))
        raise ValueError(
            f"col_idx[{i}] = {ci[i]} out of range [0, {V})"
        )
    # in-row sorted columns (vectorized: the only allowed descents in
    # the flat array are at row boundaries)
    if E > 1:
        desc = np.flatnonzero(ci[1:] < ci[:-1]) + 1
        boundaries = rp[1:-1]
        if desc.size and not np.isin(desc, boundaries).all():
            i = int(desc[~np.isin(desc, boundaries)][0])
            raise ValueError(
                f"col_idx not sorted within its row at edge {i}"
            )
    if w.shape[0] != E:
        raise ValueError(f"edge_weight has {w.shape[0]} entries != {E}")
    if E and not np.isfinite(w).all():
        raise ValueError("edge_weight contains NaN/Inf")
    if E and (w < 0).any():
        raise ValueError("edge_weight contains negative weights")


def validate_walks(walks, num_nodes: int) -> None:
    """Check a walk corpus: int tokens in [-1, V), -1 only as pads.

    The trainers mask -1 and read the rest as row ids, so a token >= V
    would read past the table (the card's row gather writes zeros for it);
    this catches it eagerly on the host.
    Also checks pads are trailing per walk — every producer (dead-end
    termination, subsample compaction) leaves live tokens contiguous
    at the front, and the window mask assumes it.
    """
    wk = np.asarray(walks)
    if wk.ndim != 2:
        raise ValueError(f"walks must be [NW, L], got shape {wk.shape}")
    if not np.issubdtype(wk.dtype, np.integer):
        raise ValueError(f"walks must be integer, got {wk.dtype}")
    if wk.size == 0:
        return
    lo, hi = int(wk.min()), int(wk.max())
    if lo < -1 or hi >= num_nodes:
        raise ValueError(
            f"walk tokens span [{lo}, {hi}] outside [-1, {num_nodes})"
        )
    alive = wk >= 0
    # pads trailing: once a walk hits -1 it must stay -1
    if (alive[:, 1:] & ~alive[:, :-1]).any():
        r = int(np.argmax((alive[:, 1:] & ~alive[:, :-1]).any(axis=1)))
        raise ValueError(
            f"walk {r} has a live token after a -1 pad (pads must be "
            "trailing)"
        )


def _floats(out):
    """The floating tensors in out (a tensor, or nested tuples, lists and
    dicts of them)."""
    if isinstance(out, torch.Tensor):
        return [out] if out.is_floating_point() else []
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _floats(o)]
    return []


def checked(fn, *, index=True, nan=True, div=True):
    """Wrap `fn` so that a NaN (`nan`) or an Inf (`div`, the result of a
    division by zero) in any floating tensor it returns raises
    ``FloatingPointError`` after the call. Usage::

        from graphembedding_tpu_torch.ops.walk import uniform_walks
        walks = checked(uniform_walks)(rp, ci, deg, starts, length=10,
                                       generator=gen)

    `index` is accepted for the JAX package's signature: eager PyTorch
    raises on an out-of-range gather or scatter index itself (an
    IndexError on the CPU, a device assert on the card). The check reads
    every output once, so it synchronizes with the device: a debugging
    tool and a test harness, not a production default.
    """
    del index

    def run(*args, **kw):
        out = fn(*args, **kw)
        for t in _floats(out):
            if nan and bool(torch.isnan(t).any()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', fn)!s} produced a NaN")
            if div and bool(torch.isinf(t).any()):
                raise FloatingPointError(
                    f"{getattr(fn, '__name__', fn)!s} produced an Inf")
        return out

    return run


@contextmanager
def debug_guard(nans: bool = True, disable_jit: bool = False):
    """Run the body with `torch.autograd.set_detect_anomaly(nans)` and
    restore the previous setting afterwards.

    Anomaly detection raises in the backward pass at the operation whose
    gradient turned NaN, with the forward trace that made it: the
    interactive complement to `checked`. `disable_jit` is accepted for
    the JAX package's signature and does nothing: eager PyTorch runs
    every operation as it is called.
    """
    del disable_jit
    prev = torch.is_anomaly_enabled()
    try:
        torch.autograd.set_detect_anomaly(nans)
        yield
    finally:
        torch.autograd.set_detect_anomaly(prev)
