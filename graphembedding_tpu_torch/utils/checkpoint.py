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
- `save_sharded` / `try_restore_sharded` do the same for the ranks of a
  mesh: each rank writes and reads its own file, `<path>/rank<r>.pt`, and
  a checkpoint of another world size, shard shape or trainer is refused on
  every rank together;
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


def save_state(path: str, state: Any, name: str = STATE_FILE) -> None:
    """Write the dict `state` to `<path>/<name>` (replacing a previous
    checkpoint there), creating `path` if needed."""
    os.makedirs(path, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path, prefix=".state-", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_to_cpu(state), f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(path, name))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str, name: str = STATE_FILE) -> Any:
    """Read the checkpoint `<path>/<name>` onto the CPU."""
    return torch.load(os.path.join(path, name), map_location="cpu",
                      weights_only=True)


def try_restore(path: str, expected_keys,
                name: str = STATE_FILE) -> Optional[Any]:
    """The checkpoint in `path`, or None when there is none.

    Raises ValueError when a checkpoint exists but lacks `expected_keys`
    (one written by another trainer or mode): a silent restart from step 0
    would retrain everything and then overwrite the old state.
    """
    if not os.path.exists(os.path.join(path, name)):
        return None
    state = load_state(path, name)
    missing = [k for k in expected_keys if k not in state]
    if missing:
        raise ValueError(
            f"checkpoint at {path!r} lacks keys {missing} (has "
            f"{sorted(state)}); it was written by a different trainer or "
            "mode; refusing to silently restart from step 0")
    return state


def save_sharded(path: str, state: Any, mesh) -> None:
    """This rank's part of a mesh checkpoint: `state` plus the world size,
    to `<path>/rank<r>.pt`, by `save_state`'s temporary file and rename."""
    save_state(path, {**state, "world_size": mesh.size()},
               f"rank{mesh.rank}.pt")


def try_restore_sharded(path: str, template, mesh) -> Optional[Any]:
    """This rank's part of the mesh checkpoint in `path`, or None when there
    is none (counterpart of the JAX package's `try_restore_sharded`).

    `template` maps each expected key to a tensor of the shape this rank
    holds (or to None: no shape to check). Raises ValueError, on every rank
    together, when any rank's file lacks keys (`try_restore`'s refusal; a
    single-device checkpoint in `path` lacks the world size), was written
    at another world size or holds a shard of another shape, or when only
    some ranks have a file.
    """
    name = f"rank{mesh.rank}.pt"
    keys = tuple(template) + ("world_size",)
    state, err = None, None
    try:
        if os.path.exists(os.path.join(path, name)):
            state = try_restore(path, keys, name)
            if int(state["world_size"]) != mesh.size():
                raise ValueError(
                    f"checkpoint at {path!r} was written by "
                    f"{int(state['world_size'])} ranks, not {mesh.size()}")
            for k, t in template.items():
                if t is not None and tuple(state[k].shape) != tuple(t.shape):
                    raise ValueError(
                        f"checkpoint at {path!r}: {k} has shard shape "
                        f"{tuple(state[k].shape)}, not {tuple(t.shape)}")
        elif os.path.exists(os.path.join(path, STATE_FILE)):
            try_restore(path, keys)  # a single-device checkpoint: refused
    except ValueError as e:
        err = e
    from graphembedding_tpu_torch.parallel import comm

    flags = comm.all_reduce(torch.tensor(
        [state is not None, err is not None], dtype=torch.int32,
        device=mesh.device), None).tolist()
    if flags[1]:
        raise err or ValueError(
            f"another rank refused its checkpoint in {path!r}")
    if 0 < flags[0] < mesh.size():
        raise ValueError(f"checkpoint at {path!r} has files for "
                         f"{flags[0]} of {mesh.size()} ranks")
    return state


def maybe_save(path: str, every: int, n_calls: int, state_fn,
               save=None) -> bool:
    """Save `state_fn()` when the cadence hits, by `save(path, state)`
    (default `save_state`); shared by the trainers."""
    if not (path and every and n_calls % every == 0):
        return False
    (save or save_state)(path, state_fn())
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
