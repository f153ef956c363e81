"""Checkpoint / resume (`torch.save`) and the preprocessing artifact cache.

Counterpart of `graphembedding_tpu/utils/checkpoint.py`, whose Orbax
checkpoints are replaced here by one file a checkpoint directory:

- `save_state` / `load_state` write and read a dict of CPU tensors, ints,
  floats and `torch.Generator` states (the trainers' tables, step counter,
  optimizer state and random streams) as `<path>/state.pt`. A save goes to
  a temporary file in the directory first and is then renamed over the
  old one, so a crash while saving leaves the previous checkpoint whole.
  Reads use `torch.load(weights_only=True)`, which unpickles no code;
- `try_restore` refuses a checkpoint without the keys a trainer expects,
  and never restarts quietly from step 0 over someone else's state;
- `cache_artifact` / `load_artifact` cache host-side preprocessing
  products (numpy and pickle, carried as they are), keyed by
  `content_key`.
"""

from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Any, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


def _to_cpu(obj):
    """obj with every tensor copied to a contiguous CPU tensor of its own
    (a view of a wider table would otherwise save the whole storage)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", memory_format=torch.contiguous_format,
                               copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_state(path: str, state: Any) -> None:
    """Write the dict `state` to `<path>/state.pt` (replacing a previous
    checkpoint there), creating `path` if needed."""
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path, prefix=".state-", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_to_cpu(state), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, STATE_FILE))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str) -> Any:
    """Read the checkpoint in `path` onto the CPU."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)


def try_restore(path: str, expected_keys) -> Optional[Any]:
    """The checkpoint in `path`, or None when there is none.

    Raises ValueError when a checkpoint exists but lacks `expected_keys`
    (one written by another trainer or mode): a silent restart from step 0
    would retrain everything and then overwrite the old state.
    """
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        return None
    state = load_state(path)
    missing = [k for k in expected_keys if k not in state]
    if missing:
        raise ValueError(
            f"checkpoint at {path!r} lacks keys {missing} (has "
            f"{sorted(state)}); it was written by a different trainer or "
            "mode; refusing to silently restart from step 0")
    return state


def maybe_save(path: str, every: int, n_calls: int, state_fn) -> bool:
    """Save `state_fn()` when the cadence hits; shared by the trainers."""
    if not (path and every and n_calls % every == 0):
        return False
    save_state(path, state_fn())
    return True


def content_key(*arrays, extra: str = "") -> str:
    """Stable hash key for preprocessing artifacts."""
    h = hashlib.sha1()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    h.update(extra.encode())
    return h.hexdigest()[:16]


def cache_artifact(cache_dir: str, key: str, obj: Any) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    p = os.path.join(cache_dir, f"{key}.pkl")
    with open(p, "wb") as f:
        pickle.dump(obj, f)
    return p


def load_artifact(cache_dir: str, key: str) -> Optional[Any]:
    p = os.path.join(cache_dir, f"{key}.pkl")
    if not os.path.exists(p):
        return None
    with open(p, "rb") as f:
        return pickle.load(f)
