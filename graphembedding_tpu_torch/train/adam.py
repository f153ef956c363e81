"""Adam written out in the form of `optax.adam`, for SDNE and the dense
expected-SGNS trainer.

Counterpart of the JAX package's `optax.adam` (SDNE,
`graphembedding_tpu/models/sdne.py`) and of the Adam written out in
`graphembedding_tpu/train/dense.py`. One step on a parameter p with
gradient g, at count t (1 at the first step):

    m = (1 - b1) * g + b1 * m
    v = (1 - b2) * g^2 + b2 * v
    p = p - ((m / bc1) / (sqrt(v / bc2) + eps)) * lr

in float32, each operation rounded as optax rounds it (the constants
1 - b1 and 1 - b2 taken in double and rounded to float32 once). The bias
corrections bc1 = 1 - b1^t and bc2 = 1 - b2^t are computed on the host in
float32 for a chunk's steps (`bias_corrections`) and read by the steps from
a float32 tensor on the parameters' device, as the learning rates of the
SGNS trainer are: a step captured into a CUDA graph then takes each
replay's values, and the step launched one by one divides by the same
tensor. Dividing by a tensor on the card is a true division, as XLA's; a
Python float or a CPU scalar there would turn into a multiply by its
reciprocal, which rounds differently.

The state, m and v for each parameter and the step count, is tensors
(`Adam.state_dict`), which a checkpoint saves under `opt_state`.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


class AdamConfig(NamedTuple):
    """Adam's constants; hashable, so a chunk graph keys its cache by
    them."""
    lr: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


def bias_corrections(b1, b2, count, n, device):
    """float32 [n] tensors 1 - b1^t and 1 - b2^t for t = count + 1 ..
    count + n, computed on the host in float32, on `device`. Each power is
    a scalar one, so a step's factor does not depend on the chunk it is
    computed in (numpy may take an array's powers by vector code that
    rounds otherwise)."""
    one = np.float32(1)
    return tuple(torch.tensor(
        [one - np.float32(b) ** np.float32(t)
         for t in range(count + 1, count + n + 1)],
        dtype=torch.float32).to(device) for b in (b1, b2))


def adam_update(ps, gs, ms, vs, bc1, bc2, cfg: AdamConfig):
    """One Adam step on the lists of tensors ps, ms and vs in place, from
    the gradients gs and the step's bias corrections bc1 and bc2 (0-d
    float32 tensors on their device). Elementwise ops one tensor at a
    time: PyTorch's multi-tensor (`torch._foreach_*`) ops give the same
    bits, but take one block of the card per 65,536 elements, which at
    these tensors' sizes costs more device time than the launches they
    save (`benchmarks/adam_bench.py`)."""
    for p, g, m, v in zip(ps, gs, ms, vs):
        m.mul_(cfg.b1).add_(g * (1.0 - cfg.b1))
        v.mul_(cfg.b2).add_(g.square() * (1.0 - cfg.b2))
        denom = (v / bc2).sqrt_().add_(cfg.eps)
        p.sub_((m / bc1).div_(denom).mul_(cfg.lr))


class Adam:
    """Adam's state for a dict of parameters (name -> tensor, updated in
    place): m and v for each, zero at the start, and the step count."""

    def __init__(self, params: Dict[str, torch.Tensor], cfg: AdamConfig):
        self.params = params
        self.cfg = cfg
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.count = 0

    def tables(self):
        """The tensors a chunk of steps updates: "p/<name>", "m/<name>"
        and "v/<name>" for each parameter."""
        return {f"{kind}/{k}": t for kind, d in (
            ("p", self.params), ("m", self.m), ("v", self.v))
            for k, t in d.items()}

    def bias_corrections(self, n):
        """The bias corrections of the next n steps (`bias_corrections`)."""
        device = next(iter(self.params.values())).device
        return bias_corrections(self.cfg.b1, self.cfg.b2, self.count, n,
                                device)

    def step(self, grads):
        """One step from grads (name -> gradient)."""
        bc1, bc2 = self.bias_corrections(1)
        with torch.no_grad():
            adam_update(list(self.params.values()),
                        [grads[k] for k in self.params],
                        list(self.m.values()), list(self.v.values()),
                        bc1[0], bc2[0], self.cfg)
        self.count += 1

    def state_dict(self):
        return {"m": dict(self.m), "v": dict(self.v),
                "count": torch.tensor(self.count)}

    def load_state_dict(self, state):
        with torch.no_grad():
            for k in self.params:
                self.m[k].copy_(state["m"][k])
                self.v[k].copy_(state["v"][k])
        self.count = int(state["count"])
