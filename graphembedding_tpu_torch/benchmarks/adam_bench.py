"""Device time of the Adam that SDNE and the dense trainer use, on the
card.

Three forms of one Adam step, timed in turns (torch, written-out,
multi-tensor, multi-tensor, written-out, torch), the median of 3 rounds:
- written-out: `train/adam.py::adam_update`, elementwise ops in optax's
  order one tensor at a time, the bias corrections divided by as device
  tensors (what the trainers run);
- multi-tensor: the same ops through `torch._foreach_*` (the same bits,
  a dozen launches a step for all the tensors);
- torch: `torch.optim.Adam` with its `foreach` kernels (SDNE's Adam
  before it was written out; it rounds otherwise).
On two sets of tensors: SDNE [256, 128]'s parameters over V nodes for the
40 steps of a 40-epoch full-batch train, and the dense trainer's two [V,
128] tables for its 300 steps (V = 2405, the Wiki-scale graph, by
default). The device time is summed over the steps' kernels
(torch.profiler), so the host's launch time does not count. One JSON line
a set, with the card's name and power limit.

    python -m graphembedding_tpu_torch.benchmarks.adam_bench [--nodes V]

Needs a CUDA card; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import json
import statistics

import torch

from graphembedding_tpu_torch.benchmarks.common import require_card
from graphembedding_tpu_torch.benchmarks.train_profile import (
    breakdown,
    device_events,
)
from graphembedding_tpu_torch.models.sdne import Autoencoder
from graphembedding_tpu_torch.train.adam import (
    AdamConfig,
    adam_update,
    bias_corrections,
)


def multi_tensor_update(ps, gs, ms, vs, bc1, bc2, cfg):
    """`adam_update` through PyTorch's multi-tensor ops."""
    torch._foreach_mul_(ms, cfg.b1)
    torch._foreach_add_(ms, torch._foreach_mul(gs, 1.0 - cfg.b1))
    torch._foreach_mul_(vs, cfg.b2)
    torch._foreach_add_(vs, torch._foreach_mul(torch._foreach_mul(gs, gs),
                                               1.0 - cfg.b2))
    denom = torch._foreach_div(vs, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    update = torch._foreach_div(ms, bc1)
    torch._foreach_div_(update, denom)
    torch._foreach_mul_(update, cfg.lr)
    torch._foreach_sub_(ps, update)


def measure(what, params, steps, cfg, dev, card):
    """Times the three forms on copies of `params` over `steps` steps of
    random gradients; prints and returns the record."""
    gen = torch.Generator(device=dev).manual_seed(1)
    grads = [[torch.randn(p.shape, generator=gen, device=dev) * 1e-2
              for p in params] for _ in range(steps)]
    bc1, bc2 = bias_corrections(cfg.b1, cfg.b2, 0, steps, dev)

    def states():
        return ([p.clone() for p in params],
                [torch.zeros_like(p) for p in params],
                [torch.zeros_like(p) for p in params])

    def stepping(update):
        ps, ms, vs = states()

        def run():
            for s, gs in enumerate(grads):
                update(ps, gs, ms, vs, bc1[s], bc2[s], cfg)
        return run, ps

    written, written_ps = stepping(adam_update)
    multi, multi_ps = stepping(multi_tensor_update)
    leaves = [p.clone().requires_grad_() for p in params]
    library = torch.optim.Adam(leaves, lr=cfg.lr, betas=(cfg.b1, cfg.b2),
                               eps=cfg.eps)

    def torch_adam():
        for gs in grads:
            for p, g in zip(leaves, gs):
                p.grad = g
            library.step()

    fns = {"torch": torch_adam, "written": written, "multi_tensor": multi}
    for fn in fns.values():  # warm: lazy state, caches
        fn()
    bits = all(torch.equal(a, b) for a, b in zip(written_ps, multi_ps))
    times, events = {k: [] for k in fns}, {}
    for _ in range(3):
        for name in ("torch", "written", "multi_tensor", "multi_tensor",
                     "written", "torch"):
            prof = breakdown(device_events(fns[name]), 0)
            times[name].append(prof["device_ms"])
            events[name] = prof["device_events"]
    rec = {"what": what, "steps": steps,
           "tensors": [list(p.shape) for p in params],
           **{f"{k}_ms": statistics.median(v) for k, v in times.items()},
           **{f"{k}_events": n for k, n in events.items()},
           "written_equals_multi_tensor": bits,
           **{f"{k}_ms_all": v for k, v in times.items()}, "card": card}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    """Measure both sets of tensors; returns the records."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=2405)
    args = ap.parse_args(argv)
    dev, card = require_card()
    with torch.no_grad():
        net = Autoencoder(args.nodes, [256, 128], 0).to(dev)
        sdne = [p.detach() for p in net.parameters()]
        tables = [torch.randn((args.nodes, 128), device=dev) * 0.01
                  for _ in range(2)]
        return [measure("SDNE Adam, 40 steps", sdne, 40, AdamConfig(1e-3),
                        dev, card),
                measure("dense trainer Adam, 300 steps", tables, 300,
                        AdamConfig(0.1, b2=0.99), dev, card)]


if __name__ == "__main__":
    main()
