"""Device tracing (the JAX package's `utils/profiling.py::trace`), and the
program's own spans and counters.

The roofline model of that module is the TPU's and is not carried.

Spans and counters. `span(name, **attrs)` is a context manager around a
stretch of host code, `count(name, n)` adds to a counter, and `record()`
turns both on for its body and yields the `Recording` that keeps them:

    with record() as rec:
        model = DeepWalk(graph, device="cuda")
        model.train(hs=1)
    rec.wall_s("train.tables.huffman")

Outside a recording a span is one shared no-op context and a count
returns at once: nothing is kept, no CUDA call is made and nothing
synchronizes. Inside one a span keeps its name, its start and end from
`time.time_ns()`, its parent (the innermost span open when it opened), a
`fit` id (given, or its parent's) and its other attributes. Spans never
synchronize: a span holds the host's launches, not the device's work.
torch.profiler stamps the runtime call that launches a device operation
on the same clock, so an operation belongs to the innermost span that
holds its launch (`Recording.innermost`).

The spans of the program, innermost last (`fit` is the model's
`fit_id`, set on `walk` and `train`, inherited below them):
- `walk`: a single-card DeepWalk or Node2Vec constructor's corpus walk;
- `train`: the model's single-card skip-gram fit (`SkipGramTrainer.fit`,
  `HSTrainer.fit`);
- `train.tables`: a fit's counts, negative table or Huffman tree, keep
  probabilities and table init; `train.tables.huffman`: `build_huffman`;
- `train.prepare`: each epoch's `prepare_epoch`;
- `train.draws`: a chunk's window draws, negative ids, token blocks and
  learning rates;
- `chunk`: each `chunk_graph.run_chunk`; in it `chunk.capture` (a cache
  miss: the warm-up step and the capture), `chunk.copy_in`,
  `chunk.replay` and `chunk.copy_out`;
- `graph.view`: a `Graph` view built on a miss; `kernels.load`: the
  kernel library's build or load, once a process.
Counters: `train.steps` (steps a fit ran), `train.blocks` (the corpus'
blocks an epoch, times the epochs run), `chunk.hits` and
`chunk.captures` (the chunk-graph cache's hits and misses).

Spans and counters are kept for one thread's nesting: the program opens
them from the thread that trains.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

import numpy as np


class Span:
    """One recorded span: `name`, `start` and `end` (ns since the epoch,
    `end` None while open), `parent` (a Span or None), `fit` and `attrs`."""

    __slots__ = ("name", "start", "end", "parent", "fit", "attrs")

    def __init__(self, name, parent, fit, attrs):
        self.name = name
        self.parent = parent
        self.fit = fit
        self.attrs = attrs
        self.start = self.end = None

    def __enter__(self):
        _open.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        _open.pop()
        return False


class _NoSpan:
    """The span outside a recording: enters and exits, keeps nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_recordings = []  # the recordings on, each gets every span and count
_open = []  # the spans open, the innermost last


class Recording:
    """The spans (`spans`, in the order they opened) and counters
    (`counters`, name -> int) made while it was on."""

    def __init__(self):
        self.spans = []
        self.counters = {}

    def closed(self, name=None):
        """The spans that ended (named `name`, where given)."""
        return [s for s in self.spans if s.end is not None
                and (name is None or s.name == name)]

    def wall_s(self, name) -> float:
        """Seconds the spans named `name` lasted, summed."""
        return sum(s.end - s.start for s in self.closed(name)) / 1e9

    def innermost(self, times_ns):
        """For each time (ns since the epoch), the index into `spans` of
        the innermost ended span whose [start, end) holds it; -1 where no
        span does. Spans nest, so each piece between consecutive span
        edges has one innermost span."""
        edges = []
        for i, s in enumerate(self.spans):
            if s.end is not None and s.end > s.start:
                # at one instant: ends first (the inner one first), then
                # starts (the outer one first)
                edges.append((s.start, 1, i, i))
                edges.append((s.end, 0, -i, i))
        edges.sort()
        stack, at, label = [], [], []
        for k, (t, opens, _, i) in enumerate(edges):
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            if k + 1 == len(edges) or edges[k + 1][0] != t:
                at.append(t)
                label.append(stack[-1] if stack else -1)
        t = np.asarray(times_ns, dtype=np.int64)
        if not at:
            return np.full(t.shape, -1, np.int64)
        k = np.searchsorted(np.asarray(at, np.int64), t, side="right") - 1
        return np.where(k >= 0, np.asarray(label, np.int64)[
            np.maximum(k, 0)], -1)


def span(name, **attrs):
    """A span named `name` around the body of a `with`; `fit=` sets its
    fit id (otherwise its parent's), the other keywords its attributes.
    Outside a recording, the shared no-op context."""
    if not _recordings:
        return _NO_SPAN
    parent = _open[-1] if _open else None
    fit = attrs.pop("fit", None)
    if fit is None and parent is not None:
        fit = parent.fit
    s = Span(name, parent, fit, attrs)
    for rec in _recordings:
        rec.spans.append(s)
    return s


def count(name, n=1):
    """Add n to the counter `name` of every recording that is on."""
    for rec in _recordings:
        rec.counters[name] = rec.counters.get(name, 0) + n


@contextmanager
def record():
    """Record spans and counts in the body; yields the `Recording`. A
    recording inside another gets the spans and counts made while both
    are on, as does the outer one."""
    rec = Recording()
    _recordings.append(rec)
    try:
        yield rec
    finally:
        _recordings.remove(rec)


def _write_spans(path, spans):
    """Add the ended `spans` to the Chrome trace at `path` (a torch.profiler
    export) as complete events of this process and thread, on the trace's
    clock: `ts` counts microseconds from its `baseTimeNanoseconds`."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid, tid = os.getpid(), threading.get_native_id()
    doc["traceEvents"].extend(
        {"ph": "X", "cat": "program", "name": s.name, "pid": pid,
         "tid": tid, "ts": (s.start - base) / 1e3,
         "dur": (s.end - s.start) / 1e3,
         "args": {"fit": s.fit, **s.attrs}}
        for s in spans if s.end is not None)
    with open(path, "w") as f:
        json.dump(doc, f, default=str)


@contextmanager
def trace(path: str):
    """Profile the body with `torch.profiler` and write a Chrome trace to
    `<path>/trace.json`, creating `path`: the card's activity (kernels,
    copies and the runtime calls that launch them) where there is a card,
    the host's operations where there is none, and in both the program's
    spans made in the body (`record`). Yields the profiler, whose
    `key_averages()` give time by operation or kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                  else [ProfilerActivity.CPU])
    with record() as rec, profile(activities=activities) as prof:
        yield prof
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "trace.json")
    prof.export_chrome_trace(out)
    _write_spans(out, rec.spans)
