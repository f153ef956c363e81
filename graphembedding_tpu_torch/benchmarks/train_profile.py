"""Device time of warm DeepWalk and LINE trains on Wiki, by kernel.

For each model on the Wiki-scale graph, at the paths of `chip_smoke.py`
(DeepWalk: walk_length=10, num_walks=80, train(embed_size=128,
window_size=5, iter=3); LINE: embedding_size=128, order='second',
train(batch_size=1024, epochs=50)): one cold train, `--warm` warm trains
on the host clock (each ending in a synchronize), then one more warm train
under `torch.profiler`. Prints one JSON line a model: the warm trains'
seconds, the profiled train's device time (the sum of its device events),
the union of its device intervals (the seconds the card was busy), the
device events it ran, and the heaviest kernels (calls, ms, us a call,
share of device time), with the card's name and power limit.

    python -m graphembedding_tpu_torch.benchmarks.train_profile \
        [--warm 3] [--models deepwalk line] [--top 8]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from graphembedding_tpu_torch.benchmarks.common import require_card


def device_events(fn):
    """(name, start us, end us) of every device event of one call of fn,
    from torch.profiler. User annotations (such as the optimizer's
    `Optimizer.step` range, which the trace also draws on the device's
    timeline) are not device work and are left out. Only the CUDA
    activity is recorded: the device events are the same without the CPU
    one, which on a loop of steps records every host op and costs tens of
    seconds of host time a train."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA
            and not e.is_user_annotation]


def busy_us(events):
    """Microseconds covered by the union of the events' intervals."""
    total, end = 0.0, float("-inf")
    for _, s, e in sorted(events, key=lambda x: x[1]):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def breakdown(events, top):
    """Device time, busy time and the `top` heaviest kernels by name."""
    by = {}
    for name, s, e in events:
        calls, us = by.get(name, (0, 0.0))
        by[name] = (calls + 1, us + e - s)
    device_us = sum(us for _, us in by.values())
    heavy = sorted(by.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "device_ms": device_us / 1e3,
        "busy_ms": busy_us(events) / 1e3,
        "device_events": len(events),
        "kernels": [{"name": n[:120], "calls": c, "ms": us / 1e3,
                     "us_a_call": us / c, "share": us / device_us}
                    for n, (c, us) in heavy],
    }


def profile_model(name, train, warm, top):
    train()  # cold: builds the kernels, fills the caches
    seconds = []
    for _ in range(warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    out = {"model": name, "warm_train_s": seconds}
    out.update(breakdown(device_events(train), top))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--warm", type=int, default=3)
    p.add_argument("--models", nargs="+", default=["deepwalk", "line"],
                   choices=["deepwalk", "line"])
    p.add_argument("--top", type=int, default=8)
    return p.parse_args(argv)


def main(argv=None):
    """Profile the chosen models; returns their JSON records."""
    from graphembedding_tpu_torch import LINE, DeepWalk
    from graphembedding_tpu_torch.data import load_dataset

    args = parse_args(argv)
    dev, card = require_card()
    graph = load_dataset("wiki").graph
    trains = {}
    if "deepwalk" in args.models:
        dw = DeepWalk(graph, walk_length=10, num_walks=80, device=dev)
        trains["deepwalk"] = lambda: dw.train(embed_size=128, window_size=5,
                                              iter=3)
    if "line" in args.models:
        ln = LINE(graph, embedding_size=128, order="second", device=dev)
        trains["line"] = lambda: ln.train(batch_size=1024, epochs=50)
    results = []
    for name, train in trains.items():
        r = dict(profile_model(name, train, args.warm, args.top), card=card)
        print(json.dumps(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
