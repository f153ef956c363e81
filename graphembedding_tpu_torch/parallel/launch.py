"""Run a function on n ranks, each a spawned process, and collect results.

    results = run_ranks(fn, 2, arg, backend="gloo", device="cpu")

calls `fn(info, arg)` in every rank, where `info` is a `RankInfo`
(rank, world size, device), after `init_distributed` joined the
ranks through a `FileStore` in a temporary directory (no port to collide
on). Ranks start by `spawn`, never by fork, so a parent that holds a CUDA
context is safe. `fn` must be importable by name from a module that does not
import jax (the child imports that module). Each rank's return value comes
back through a file (`torch.save`); a rank that raises makes `run_ranks`
raise with its traceback, and a rank that outlives `timeout_s` is killed.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import tempfile
import time
import traceback
from typing import NamedTuple

import torch


class RankInfo(NamedTuple):
    rank: int
    world_size: int
    device: torch.device


def _rank_main(fn, rank, world_size, backend, device, threads, store,
               out, args):
    from graphembedding_tpu_torch.parallel.mesh import (
        destroy_distributed,
        init_distributed,
    )

    torch.set_num_threads(threads)
    device = torch.device(device)
    result = None
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        init_distributed(rank, world_size, backend, f"file://{store}")
        try:
            result = ("ok", fn(RankInfo(rank, world_size, device),
                               *args))
        finally:
            destroy_distributed()
    except BaseException:  # noqa: B902 - reported to the parent
        result = ("error", traceback.format_exc())
    torch.save(result, out)


def run_ranks(fn, world_size, *args, backend="gloo", device="cpu",
              threads=1, timeout_s=900.0):
    """[fn's return value on rank r for r in range(world_size)]."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ge_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world_size, backend, str(device),
                                   threads, store, outs[r], args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        results = {}
        try:
            # a rank that fails leaves the others waiting in a collective:
            # stop them as soon as one rank is down without a good result
            while len(results) < world_size:
                for r, p in enumerate(procs):
                    if r not in results and not p.is_alive():
                        results[r] = (torch.load(outs[r], weights_only=False)
                                      if os.path.exists(outs[r]) else
                                      ("error", f"rank {r} died (exit code "
                                       f"{p.exitcode}) with no result"))
                if any(status != "ok" for status, _ in results.values()):
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks still running after "
                                       f"{timeout_s} s; killed")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        for r, (status, value) in sorted(results.items()):
            if status != "ok":
                raise RuntimeError(f"rank {r} failed:\n{value}")
        return [results[r][1] for r in range(world_size)]
