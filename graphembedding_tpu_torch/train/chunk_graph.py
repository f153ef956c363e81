"""A chunk of training steps as one CUDA graph: the port's counterpart of
the JAX package's one compiled `lax.scan` a chunk (SGNS at
`graphembedding_tpu/train/skipgram.py:606` and `:633`, hierarchical
softmax at `train/hsoftmax.py:249`, LINE at `models/line.py:96`, SDNE at
`models/sdne.py:283`, `:337` and `:494`, the dense expected-SGNS fit at
`train/dense.py:183`).

A step of the single-device trainers is a few dozen small launches (K1-K4
and PyTorch's elementwise ops), and on an H100 the host's time to issue
them, not the card, set the pace of a warm train (PERF.md §5). `run_chunk`
captures a chunk's S steps once as a `torch.cuda.CUDAGraph` and replays
it for every later chunk of the same shapes: the host then issues one
replay a chunk. The steps inside are the same calls, on the same values,
as when they are launched one by one, so the tables come out bit for bit
the same.

What a graph reads and writes lives in buffers it owns:
- the tables the steps update in place: copied in before each replay and
  back into the caller's tensors after it (a fit may replace a table's
  tensor, as a restore from a checkpoint does; a graph writes only to
  tensors it holds);
- the chunk's inputs (token blocks, draws, learning rates as a float32
  tensor, constant masks): copied in before each replay;
- the steps' outputs (losses, pairs): the graph's own tensors, which the
  next replay overwrites, so `run_chunk` returns clones.
A step may differentiate (SDNE's): it takes its gradients by
`torch.autograd.grad` on leaves that alias its buffers, so the gradients
are tensors of the graph's pool, and the warm-up runs its forward and
backward on the capture stream before the capture.
Nothing inside a step may draw from a `torch.Generator`: the draws are
inputs, made before the chunk. PyTorch refuses a draw from any generator
but the card's default one during a capture; a draw from the default one
would be captured, and the first replay raises when it sees that
generator move (and puts it back). A capture that a refused CUDA call
invalidated leaves the default generator where it was, too.

Graphs stay in a cache keyed by the device, the names, shapes and dtypes
of the buffers, the step function, its kernels, its constants and the
float32 matmul setting (the captured cuBLAS calls depend on it), as `jit`
keys its cache by shapes, so a warm fit replays without capturing.
`release` drops them and their memory pools.

Before a capture, `kernels.build.prepare` readies every kernel on the card
without launching one, and one step runs through the plain versions on
the capture stream, so that PyTorch's lazy state (cuBLAS's workspace for
that stream) exists before the capture. Neither launches a kernel of the
port, and a capture launches nothing, so the wrappers' counts are taken
back after the capture and every replay adds the launches it holds
(`LaunchCounts`): the counts read as if the steps had been launched one by
one. A capture or a replay that fails raises; nothing falls back to the
loop.
"""

from __future__ import annotations

import contextlib
import time

import torch

from graphembedding_tpu_torch.kernels import build as kb
from graphembedding_tpu_torch.ops.rows import (
    dma_gather_rows,
    gather_rows,
    scatter_add_rows,
    scatter_add_small,
)
from graphembedding_tpu_torch.ops.sgns import sgns_block_grads

# the kernels' wrappers, each counting its launches in `launches`
COUNTERS = (sgns_block_grads, gather_rows, scatter_add_rows,
            scatter_add_small, dma_gather_rows)


class LaunchCounts:
    """The launches a captured graph holds: each counter (an object with an
    int `launches`, as a kernel's wrapper is) counts while the graph is
    captured; `capturing` takes those counts back and records them, and
    `replayed` adds them once a replay."""

    def __init__(self, counters=COUNTERS):
        self.counters = tuple(counters)
        self.per_replay = (0,) * len(self.counters)

    @contextlib.contextmanager
    def capturing(self):
        before = [c.launches for c in self.counters]
        try:
            yield
        finally:
            self.per_replay = tuple(c.launches - b for c, b in
                                    zip(self.counters, before))
            for c, b in zip(self.counters, before):
                c.launches = b

    def replayed(self):
        for c, n in zip(self.counters, self.per_replay):
            c.launches += n


def run_steps(step, n_steps, bufs, ops, consts):
    """`step(bufs, s, ops, **consts)` for s in 0 .. n_steps - 1, launched
    one by one; each step returns a tuple of 0-d tensors. Returns the
    tuple of their [n_steps] stacks."""
    outs = [step(bufs, s, ops, **consts) for s in range(n_steps)]
    return tuple(torch.stack(o) for o in zip(*outs))


class CudaCapture:
    """Capture and replay of one `torch.cuda.CUDAGraph` on a card."""

    def __init__(self, device):
        self.device = device
        self.graph = None
        self.replays = 0

    def capture(self, body, warm_up):
        """body() under capture, after warm_up() on the capture stream;
        returns body's outputs (tensors of the graph's pool)."""
        dev = self.device
        kb.prepare(dev.index)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            warm_up()
            stream.synchronize()
            rng = torch.cuda.default_generators[dev.index].get_state()
            graph.capture_begin()
            try:
                outputs = body()
            except BaseException:
                self._end_failed(graph, rng)
                raise
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = graph
        return outputs

    def _end_failed(self, graph, rng):
        """End a capture whose body raised. Where a CUDA call the capture
        refused invalidated it, PyTorch's capture_end raises before it
        takes the card's default generator out of its capture state (a
        later draw from it would raise); that generator then gets a fresh
        state at `rng`, its place before the capture."""
        try:
            graph.capture_end()
        except RuntimeError:
            fresh = torch.Generator(device=self.device)
            fresh.set_state(rng)
            torch.cuda.default_generators[self.device.index] \
                .graphsafe_set_state(fresh.graphsafe_get_state())

    def replay(self):
        """One replay on the current stream. The first checks that the
        card's default generator did not move (and puts it back if it did):
        a step that drew from it would draw anew on every replay, where the
        chunk's draws are made once, outside."""
        gen = torch.cuda.default_generators[self.device.index]
        before = gen.get_state() if self.replays == 0 else None
        self.graph.replay()
        self.replays += 1
        if before is not None and not torch.equal(gen.get_state(), before):
            gen.set_state(before)
            raise RuntimeError(
                "a captured training step drew from the card's default "
                "generator; a chunk's draws must be inputs of its steps")

    def release(self):
        if self.graph is not None:
            self.graph.reset()
            self.graph = None


# how each device type captures a chunk; a device type that is not here
# runs its steps one by one
CAPTURES = {"cuda": CudaCapture}


class ChunkGraph:
    """One captured chunk: its buffers, its outputs, its launches, and the
    host seconds its capture took (warm-up step included)."""

    def __init__(self, step, n_steps, bufs, ops, plain, consts):
        t0 = time.perf_counter()
        device = next(iter(bufs.values())).device
        self.bufs = {name: t.clone() for name, t in bufs.items()}
        self.counts = LaunchCounts()
        self.capture = CAPTURES[device.type](device)

        def body():
            with self.counts.capturing():
                return run_steps(step, n_steps, self.bufs, ops, consts)

        self.outputs = self.capture.capture(
            body, lambda: step(self.bufs, 0, plain, **consts))
        self.seconds = time.perf_counter() - t0

    def run(self, tables, inputs):
        """Copy in, replay, copy the tables back; returns clones of the
        outputs."""
        for name, t in (*tables.items(), *inputs.items()):
            self.bufs[name].copy_(t)
        self.capture.replay()
        self.counts.replayed()
        for name, t in tables.items():
            t.copy_(self.bufs[name])
        return tuple(o.clone() for o in self.outputs)


_GRAPHS: dict = {}


def run_chunk(step, n_steps, tables, inputs, *, ops=None, plain=None,
              consts=None):
    """n_steps training steps `step(bufs, s, ops, **consts)` on `tables`
    (name -> tensor, updated in place) and `inputs` (name -> tensor, read
    only); `bufs` maps every name to its tensor. Each step returns a tuple
    of 0-d tensors; returns the tuple of their [n_steps] stacks.

    On a card (a device type in CAPTURES) the steps replay one captured
    graph, cached by the buffers' layout, `step`, `ops`, `consts` (a dict
    of hashable Python values) and the float32 matmul setting; `plain`
    (the plain versions of `ops`) runs one warm-up step before a capture.
    On the CPU, or with ops `plain` (the plain versions make host round
    trips, which a capture refuses), the steps are launched one by one on
    the caller's tensors: the loop, the plain version of the graph.
    ops None is a step that launches no kernel of the port (SDNE's, the
    dense trainer's): it captures on a card, and warms up through the
    same step.
    """
    consts = consts or {}
    bufs = {**tables, **inputs}
    device = next(iter(tables.values())).device
    if (ops is not None and ops is plain) or device.type not in CAPTURES:
        return run_steps(step, n_steps, bufs, ops, consts)
    key = (str(device), step, n_steps, ops, tuple(sorted(consts.items())),
           tuple((name, tuple(t.shape), t.dtype)
                 for name, t in sorted(bufs.items())),
           torch.get_float32_matmul_precision(),
           torch.backends.cuda.matmul.allow_tf32)
    graph = _GRAPHS.get(key)
    if graph is not None:
        return graph.run(tables, inputs)
    graph = ChunkGraph(step, n_steps, bufs, ops, plain, consts)
    out = graph.run(tables, inputs)  # a graph whose first replay fails is
    _GRAPHS[key] = graph             # not kept
    return out


def _keys(device):
    """The cache's keys on `device` (a card named without its index is the
    current one), or all of them for None."""
    if device is None:
        return list(_GRAPHS)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return [k for k in _GRAPHS if k[0] == str(device)]


def held(device=None):
    """The chunk graphs held (on `device`, or on every device)."""
    return [_GRAPHS[k] for k in _keys(device)]


def release(device=None):
    """Drop the chunk graphs held (on `device`, or on every device) with
    their buffers and memory pools; the next chunk of each shape captures
    again."""
    for key in _keys(device):
        _GRAPHS.pop(key).capture.release()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
