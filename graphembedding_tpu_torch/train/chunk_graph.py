"""A chunk of training steps as one CUDA graph: the port's counterpart of
the JAX package's one compiled `lax.scan` a chunk (SGNS at
`graphembedding_tpu/train/skipgram.py:606` and `:633`, hierarchical
softmax at `train/hsoftmax.py:249`, LINE at `models/line.py:96`, SDNE at
`models/sdne.py:283`, `:337` and `:494`, the dense expected-SGNS fit at
`train/dense.py:183`; over a mesh, the `jit(shard_map(... lax.scan ...))`
of `parallel/rowshard.py:300`, `parallel/sgns.py:235`,
`parallel/hsoftmax.py:197`, `parallel/line.py:111` and
`parallel/sdne.py:98` and `:248`).

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
A step may leave tensors for the next step of its chunk in its `bufs`
under a name of its own (the row-sharded step's prefetched rows, a dp
step's replica base): each run of a chunk's steps, and the warm-up, gets
its own copy of the dict.
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

A step of a mesh trainer exchanges over process groups (`groups`). A
graph captures an NCCL collective as graph nodes that hold the group's
communicator; gloo stages an exchange of a CUDA tensor through host
memory (`parallel.comm.host_staged`), which a capture refuses. So the rule
is by backend, decided before any capture: a chunk whose exchanges are
all on the card (NCCL, or gloo on CPU tensors) takes the graph path, and
one with a host-staged exchange runs its steps one by one.

Graphs stay in a cache keyed by the device, the process groups the steps
exchange over with this process' rank, the names, shapes and dtypes of
the buffers, the step function, its kernels, its constants and the
float32 matmul setting (the captured cuBLAS calls depend on it), as `jit`
keys its cache by shapes, so a warm fit replays without capturing, and a
graph never replays under a group other than the one it was captured
with. The key holds the group objects, so a group created after another
was destroyed never matches the old one's graphs. `release` drops graphs
and their memory pools (those of one group with `group=`); a process
releases them before `torch.distributed.destroy_process_group`
(`parallel.mesh.destroy_distributed`).

The cache is bounded on each device by `BUDGET_BYTES`. A graph costs the
bytes of the buffers it owns plus the growth of the device's reserved
memory over its capture (its private memory pool). The cache
drops the least recently replayed graphs of a device, as `release` does:
before a capture, until the others and the new graph's buffers fit the
budget; after it, until all fit, the new graph kept. A graph larger than
the budget is still kept, alone. A replay makes a graph the most recent,
so a train that runs one shape chunk after chunk never captures twice.

Before a capture, `kernels.build.prepare` readies every kernel on the card
without launching one, and one step runs through the plain versions on
the capture stream, so that PyTorch's lazy state (cuBLAS's workspace for
that stream, an NCCL group's communicator, made at its first collective)
exists before the capture. Neither launches a kernel of the
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
from graphembedding_tpu_torch.utils.profiling import count, span

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
    one by one, on a copy of the dict bufs (which a step may add to for
    its next step); each step returns a tuple of 0-d tensors. Returns the
    tuple of their [n_steps] stacks."""
    bufs = dict(bufs)
    outs = [step(bufs, s, ops, **consts) for s in range(n_steps)]
    return tuple(torch.stack(o) for o in zip(*outs))


class CudaCapture:
    """Capture and replay of one `torch.cuda.CUDAGraph` on a card."""

    def __init__(self, device):
        self.device = device
        self.graph = None
        self.replays = 0
        self.pool_bytes = 0

    def capture(self, body, warm_up):
        """body() under capture, after warm_up() on the capture stream;
        returns body's outputs (tensors of the graph's pool). Sets
        `pool_bytes`: the card's reserved memory the capture added, the
        graph's private memory pool."""
        dev = self.device
        kb.prepare(dev.index)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), torch.cuda.stream(stream):
            warm_up()
            stream.synchronize()
            rng = torch.cuda.default_generators[dev.index].get_state()
            reserved = torch.cuda.memory_reserved(dev)
            graph.capture_begin()
            try:
                outputs = body()
            except BaseException:
                self._end_failed(graph, rng)
                raise
            graph.capture_end()
        self.pool_bytes = max(torch.cuda.memory_reserved(dev) - reserved, 0)
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


def tensor_bytes(tensors):
    """The bytes of the tensors' elements."""
    return sum(t.numel() * t.element_size() for t in tensors)


class ChunkGraph:
    """One captured chunk: its buffers, its outputs, its launches, the
    host seconds its capture took (warm-up step included), and its cost in
    bytes (`nbytes`: its buffers, and its capture's memory pool where the
    capture reports one as `pool_bytes`)."""

    def __init__(self, step, n_steps, bufs, ops, plain, consts, groups=()):
        t0 = time.perf_counter()
        self.groups = groups
        device = next(iter(bufs.values())).device
        self.bufs = {name: t.clone() for name, t in bufs.items()}
        self.counts = LaunchCounts()
        self.capture = CAPTURES[device.type](device)

        def body():
            with self.counts.capturing():
                return run_steps(step, n_steps, self.bufs, ops, consts)

        self.outputs = self.capture.capture(
            body, lambda: step(dict(self.bufs), 0, plain, **consts))
        self.nbytes = tensor_bytes(self.bufs.values()) + getattr(
            self.capture, "pool_bytes", 0)
        self.seconds = time.perf_counter() - t0

    def run(self, tables, inputs):
        """Copy in, replay, copy the tables back; returns clones of the
        outputs."""
        with span("chunk.copy_in"):
            for name, t in (*tables.items(), *inputs.items()):
                self.bufs[name].copy_(t)
        with span("chunk.replay"):
            self.capture.replay()
        self.counts.replayed()
        with span("chunk.copy_out"):
            for name, t in tables.items():
                t.copy_(self.bufs[name])
            return tuple(o.clone() for o in self.outputs)


# The most bytes the chunk graphs of one device may hold (`ChunkGraph.
# nbytes`). 16 GiB is a fifth of an 80 GB H100: it holds the largest graphs
# the port's trains capture (on an H100: DeepWalk at V = 1M, 3.0 GiB with
# the sparse cap and 5.7 GiB with the dense one; SDNE `train_sparse` at
# V = 100,000 reserved about 11 GiB with its warm-up) beside a few small
# ones, and leaves the rest of the card to the train in flight: its
# tables, corpus and optimiser state live outside the cache.
BUDGET_BYTES = 16 << 30

# the cached graphs by key, the least recently replayed first
_GRAPHS: dict = {}


def _evict(device, need=0, keep=None):
    """Drop the least recently replayed graphs on `device` (a str), never
    `keep`, until those left plus `need` bytes fit BUDGET_BYTES."""
    keys = [k for k in _GRAPHS if k[0] == device]
    total = need + sum(_GRAPHS[k].nbytes for k in keys)
    dropped = False
    for key in keys:
        if total <= BUDGET_BYTES:
            break
        if key == keep:
            continue
        graph = _GRAPHS.pop(key)
        total -= graph.nbytes
        graph.capture.release()
        dropped = True
    if dropped and device.startswith("cuda"):
        torch.cuda.empty_cache()


def join_groups(groups, device):
    """One small all-reduce on each of `groups` before a capture. NCCL
    creates a group's communicator at the group's first collective, which
    a capture refuses ("operation not permitted when stream is
    capturing"), and the warm-up step need not exchange: a dp step syncs
    its replicas every few steps only. Every rank captures the same chunk,
    so every rank joins the same groups in the same order."""
    import torch.distributed as dist

    for group in groups:
        dist.all_reduce(torch.zeros(1, device=device), group=group)


def run_chunk(step, n_steps, tables, inputs, *, ops=None, plain=None,
              consts=None, groups=()):
    """n_steps training steps `step(bufs, s, ops, **consts)` on `tables`
    (name -> tensor, updated in place) and `inputs` (name -> tensor, read
    only); `bufs` maps every name to its tensor. Each step returns a tuple
    of 0-d tensors; returns the tuple of their [n_steps] stacks.

    On a card (a device type in CAPTURES) the steps replay one captured
    graph, cached by the buffers' layout, `step`, `ops`, `consts` (a dict
    of hashable Python values), `groups` and the float32 matmul setting;
    `plain` (the plain versions of `ops`) runs one warm-up step before a
    capture. On the CPU, or with ops `plain` (the plain versions make host
    round trips, which a capture refuses), or when an exchange on one of
    `groups` (the process groups the steps exchange over, every rank
    running the same chunks) is staged through the host, the steps are
    launched one by one on the caller's tensors: the loop, the plain
    version of the graph. ops None is a step that launches no kernel of
    the port (SDNE's, the dense trainer's): it captures on a card, and
    warms up through the same step.
    """
    with span("chunk"):
        return _run_chunk(step, n_steps, tables, inputs, ops, plain,
                          consts or {}, groups)


def _run_chunk(step, n_steps, tables, inputs, ops, plain, consts, groups):
    bufs = {**tables, **inputs}
    device = next(iter(tables.values())).device
    if groups:
        import torch.distributed as dist

        from graphembedding_tpu_torch.parallel.comm import host_staged

        groups = tuple(dist.group.WORLD if g is None else g for g in groups)
        staged = any(host_staged(g, device) for g in groups)
        ranks = (dist.get_rank(), *(dist.get_rank(g) for g in groups))
    else:
        staged, ranks = False, ()
    if ((ops is not None and ops is plain) or staged
            or device.type not in CAPTURES):
        return run_steps(step, n_steps, bufs, ops, consts)
    key = (str(device), groups, ranks, step, n_steps, ops,
           tuple(sorted(consts.items())),
           tuple((name, tuple(t.shape), t.dtype)
                 for name, t in sorted(bufs.items())),
           torch.get_float32_matmul_precision(),
           torch.backends.cuda.matmul.allow_tf32)
    graph = _GRAPHS.pop(key, None)
    if graph is not None:
        count("chunk.hits")
        _GRAPHS[key] = graph  # the most recent
        return graph.run(tables, inputs)
    count("chunk.captures")
    with span("chunk.capture"):
        _evict(key[0], tensor_bytes(bufs.values()))
        join_groups(groups, device)
        graph = ChunkGraph(step, n_steps, bufs, ops, plain, consts, groups)
    out = graph.run(tables, inputs)  # a graph whose first replay fails is
    _GRAPHS[key] = graph             # not kept
    _evict(key[0], keep=key)
    return out


def _keys(device, group=None):
    """The cache's keys on `device` (a card named without its index is the
    current one; None: every device) whose steps exchange over `group`
    (None: any keys)."""
    keys = list(_GRAPHS)
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        keys = [k for k in keys if k[0] == str(device)]
    if group is not None:
        keys = [k for k in keys if group in _GRAPHS[k].groups]
    return keys


def held(device=None, group=None):
    """The chunk graphs held (on `device`, or on every device; with
    `group`, those whose steps exchange over that process group), the
    least recently replayed first."""
    return [_GRAPHS[k] for k in _keys(device, group)]


def held_bytes(device=None, group=None):
    """The bytes the graphs `held(device, group)` cost (`ChunkGraph.
    nbytes`), which BUDGET_BYTES bounds on each device."""
    return sum(g.nbytes for g in held(device, group))


def release(device=None, group=None):
    """Drop the chunk graphs held (on `device`, or on every device; with
    `group`, those whose steps exchange over that process group) with
    their buffers and memory pools; the next chunk of each shape captures
    again."""
    for key in _keys(device, group):
        _GRAPHS.pop(key).capture.release()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
