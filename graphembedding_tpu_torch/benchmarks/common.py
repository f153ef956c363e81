"""What the benchmarks share: the card check and CUDA-event timing."""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

HOLD_CYCLES = 4_000_000  # about 2 ms of the card's clock a queued call


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


def timed_ms(fn, reps):
    """Device ms a call of fn over reps calls between two CUDA events. The
    card first spins while the host queues the calls, so the host's launch
    time does not show between the events."""
    torch.cuda._sleep(HOLD_CYCLES * reps)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def median_ms(fn, runs=20, warmup=3):
    """Median of `runs` single calls timed by `timed_ms`, after warm-up."""
    for _ in range(warmup):
        fn()
    return statistics.median(timed_ms(fn, 1) for _ in range(runs))


def turns_ms(kernel, other, rounds=10, reps=5):
    """Median ms a call of kernel and of other, timed in turns (other,
    kernel, kernel, other, ...) of `reps` calls each, so that drift of the
    card's clocks falls on both alike."""
    fns = (kernel, other)
    for fn in fns:
        for _ in range(3):
            fn()
    times = ([], [])
    for _ in range(rounds):
        for which in (1, 0, 0, 1):
            times[which].append(timed_ms(fns[which], reps))
    return statistics.median(times[0]), statistics.median(times[1])
