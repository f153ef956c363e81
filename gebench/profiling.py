"""The card check, the device trace of a run, and the program's own
recording (`graphembedding_tpu_torch.utils.profiling.record`).

`require_card` is copied from `graphembedding_tpu_torch/benchmarks/
common.py`, and `busy_us` and the by-name totals of `top_ops` from
`graphembedding_tpu_torch/benchmarks/train_profile.py` (`busy_us`,
`breakdown`); `Trace` records, as `train_profile.device_events` does, the
CUDA activity alone, and keeps each device operation's correlation with
the host call that launched it, so that an operation belongs to the span
whose call launched it.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch


def require_card(chips: int = 1):
    """(torch.device('cuda'), 'name, power limit' from nvidia-smi); exits
    non-zero where there is no card or fewer than `chips`: the benchmark
    never falls back to the CPU."""
    if not torch.cuda.is_available():
        sys.exit("this benchmark needs a CUDA card "
                 "(torch.cuda.is_available() is false)")
    if torch.cuda.device_count() < chips:
        sys.exit(f"the cell asks for {chips} cards, torch sees "
                 f"{torch.cuda.device_count()}")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        sys.exit(f"nvidia-smi failed: {out.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda"), out.stdout.strip().splitlines()[0]


def busy_us(start, end) -> float:
    """Microseconds covered by the union of the intervals [start, end)
    (arrays)."""
    start, end = np.asarray(start, float), np.asarray(end, float)
    if not start.size:
        return 0.0
    order = np.argsort(start, kind="stable")
    s, e = start[order], end[order]
    reach = np.maximum.accumulate(e)
    before = np.concatenate([[-np.inf], reach[:-1]])
    return float(np.maximum(0.0, reach - np.maximum(s, before)).sum())


def idle_stretches(start, end, t0, t1):
    """(from, to) arrays of the stretches of [t0, t1] that no interval
    [start, end) covers."""
    order = np.argsort(start, kind="stable")
    s, e = np.asarray(start, float)[order], np.asarray(end, float)[order]
    reach = np.maximum.accumulate(e) if s.size else e
    a = np.concatenate([[t0], reach])
    b = np.concatenate([s, [t1]])
    a = np.maximum(a, t0)
    keep = b > a
    return a[keep], b[keep]


class Ops:
    """Device operations as arrays: `names` (each distinct name once),
    `name` (index into names), `start`, `end` and `launch` (the start of
    the runtime call that launched it; NaN where the trace holds none),
    all in microseconds since the epoch on the profiler's clock."""

    def __init__(self, names, name, start, end, launch):
        self.names = names
        self.name = np.asarray(name, np.int64)
        self.start = np.asarray(start, float)
        self.end = np.asarray(end, float)
        self.launch = np.asarray(launch, float)

    @classmethod
    def from_list(cls, ops):
        """From (name, start, end, launch or None) tuples."""
        names = sorted({o[0] for o in ops})
        at = {n: i for i, n in enumerate(names)}
        return cls(names, [at[o[0]] for o in ops], [o[1] for o in ops],
                   [o[2] for o in ops],
                   [np.nan if o[3] is None else o[3] for o in ops])

    def __len__(self):
        return int(self.start.size)


class Trace:
    """torch.profiler over a window, CUDA activity only; `stop` leaves the
    window's device operations in `ops` (`Ops`), each with the start of
    the runtime call it correlates with."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.ops = None

    def start(self):
        torch.cuda.synchronize()
        self._prof.start()

    def stop(self):
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        t1 = time.perf_counter()
        names, name, start, end, corr, launch = {}, [], [], [], [], {}
        for e in events:
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation():
                    continue
                name.append(names.setdefault(e.name(), len(names)))
                t = e.start_ns()
                start.append(t)
                end.append(t + e.duration_ns())
                corr.append(e.correlation_id())
            else:
                launch.setdefault(e.correlation_id(), e.start_ns())
        del events
        self._prof = None
        nan = float("nan")
        self.ops = Ops(list(names), name, np.asarray(start, float) / 1e3,
                       np.asarray(end, float) / 1e3,
                       np.asarray([launch.get(c, nan) for c in corr],
                                  float) / 1e3)
        print(f"trace: stopped in {t1 - t0:.1f} s, read in "
              f"{time.perf_counter() - t1:.1f} s", file=sys.stderr)


def top_ops(ops: Ops, n):
    """[name, seconds] of the n device operations with the most time."""
    us = np.bincount(ops.name, weights=ops.end - ops.start,
                     minlength=len(ops.names))
    heavy = np.argsort(-us, kind="stable")[:n]
    return [[ops.names[i][:120], float(us[i]) / 1e6] for i in heavy
            if us[i] > 0]


def program_record():
    """The program's `record()`, or None where the program has none."""
    try:
        from graphembedding_tpu_torch.utils.profiling import record
    except ImportError:
        return None
    return record


def op_spans(rec, ops: Ops):
    """Each operation's innermost program span holding its launch, from
    the program's recording `rec`: an array of span names, '' where none
    does or the launch is unknown."""
    launch = np.where(np.isnan(ops.launch), -1.0, np.round(ops.launch * 1e3))
    at = rec.innermost(launch.astype(np.int64))  # -1: before every span
    names = np.array([s.name for s in rec.spans] + [""])
    return names[np.where(at >= 0, at, len(rec.spans))]
