"""Device tracing (the JAX package's `utils/profiling.py::trace`).

The roofline model of that module is the TPU's and is not carried.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch


@contextmanager
def trace(path: str):
    """Profile the body with `torch.profiler` (the host, and the card when
    there is one) and write a Chrome trace to `<path>/trace.json`, creating
    `path`. Yields the profiler, whose `key_averages()` give time by
    operation and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    os.makedirs(path, exist_ok=True)
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
