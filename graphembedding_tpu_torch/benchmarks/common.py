"""What the benchmarks share: the card check and CUDA-event timing."""

from __future__ import annotations

import subprocess
import sys

import torch


def require_card():
    """(torch.device('cuda'), 'name, power limit' from nvidia-smi); exits
    non-zero where there is no card: a benchmark never falls back to the
    CPU."""
    if not torch.cuda.is_available():
        sys.exit("this benchmark needs a CUDA card "
                 "(torch.cuda.is_available() is false)")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        sys.exit(f"nvidia-smi failed: {out.stderr.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda"), out.stdout.strip().splitlines()[0]


def best_seconds(fn, make_input, reps):
    """Best of `reps` timed calls fn(make_input(r)), r = 1..reps, after an
    untimed call on make_input(0); CUDA events around each call, inputs
    made outside the timed region."""
    best = float("inf")
    for r in range(reps + 1):
        x = make_input(r)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn(x)
        b.record()
        b.synchronize()
        if r > 0:
            best = min(best, a.elapsed_time(b) / 1e3)
    return best
