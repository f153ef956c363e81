"""The benchmark's run: one cell of `BENCHMARK.json`, whole fits of the
port (`graphembedding_tpu_torch`) through its public model API.

A cell names a configuration (`configs/<config>.json`: the model and its
training as a user runs it), a traffic mix (`traffic/<traffic>.json`:
the graph) and may have a file of its own (`cells/<workload>.json`: the
corpus cut to fit a window, the limits of its check). The configuration's
`model`, in lower case, names the module that builds, trains, counts and
judges its fits (`models/<model>.py`, interface in `models/__init__.py`).
A per-layer metric is a reader of its own (`metrics/<metric>.py`). Each
is found by its name, so a new model, cell, mix or metric is a new file.

Set-up: the traffic's graph, made on the device from its `graph_seed`,
handed to the port as a `Graph.from_csr`; one whole fit, which builds the
graph's device views, loads the kernels and captures the chunk graphs.
Window: whole fits, each built on the same `Graph` (the model module's
`build`, the `walk` span) and trained (`train`, the `train` span), each
with a seed of its own, each span ending in a synchronize, until
`seconds` have passed; the fit in flight then runs to its end. After the
window, a fit drawn from the seed is judged by its module's `judge`
against the plain reference. A traced run (`--trace 1`) records the
device's operations and, where the program has `record()`, its own spans
and counters over the set-up and the window.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field
from types import ModuleType

import numpy as np
import torch

from gebench import check, graphgen, profiling
from gebench.reference.walks import Csr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "graphembedding_tpu")
PEAKS_FILE = os.path.join(ROOT, "gebench", "peaks.json")


def _json(path):
    with open(path) as f:
        return json.load(f)


def peaks():
    """The card's published peaks (`peaks.json`)."""
    return _json(PEAKS_FILE)


_modules = {}  # path -> a model module, loaded once a process


def model_module(model: str, root: str = ROOT) -> ModuleType:
    """`gebench/models/<model in lower case>.py` under `root`, loaded once:
    a test that patches it patches what every run of the process calls."""
    path = os.path.join(root, "gebench", "models", model.lower() + ".py")
    if path not in _modules:
        if not os.path.exists(path):
            raise SystemExit(f"no model module for model {model!r}: "
                             f"{os.path.relpath(path, root)} is missing")
        spec = importlib.util.spec_from_file_location(
            "gebench_model_" + model.lower().replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[path] = mod
    return _modules[path]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # as run: the configuration file with the cell's cuts
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: dict  # name -> unit of the per-layer metrics it reports
    model: ModuleType  # `models/<model>.py`
    root: str = ROOT  # the checkout whose gebench/ holds the cell's files


def reports(metric: dict, cell: str, end_to_end: list) -> bool:
    """Whether a per-layer metric is read in a cell: the cell is in its
    `workloads`, or it has none and the cell reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in end_to_end


def load_cell(root: str, workload: str, limits: bool = True) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json, its files found by
    the names there. Exits where its model has no module or, with
    `limits`, where its cell file lacks a limit for one of the module's
    `CHECKS` (`calibrate.py`, which reads what limits are set from, loads
    a cell without them)."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, conf["file"]))
    model = model_module(config["model"], root)
    here = os.path.join(root, "gebench")
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    cell_file = os.path.join(here, "cells", workload + ".json")
    own = _json(cell_file) if os.path.exists(cell_file) else {}
    missing = [n for n in model.CHECKS if n not in own.get("limits", {})]
    if limits and missing:
        raise SystemExit(f"cell {workload!r}: no limit for {missing} in "
                         f"{os.path.relpath(cell_file, root)}")
    run_cfg = {k: v for k, v in config.items()
               if k not in ("source", "reduced", "assumed", "why")}
    run_cfg.update(own.get("corpus", {}))
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    per_layer = {m["name"]: m["unit"] for m in bench["per_layer"]
                 if reports(m, workload, e2e)}
    return Cell(workload, int(w.get("chips", 1)), run_cfg, traffic,
                own.get("limits", {}), e2e, per_layer, model, root)


def metric_reader(name: str, root: str = ROOT):
    """`read(run)` of `gebench/metrics/<name>.py` under `root`."""
    path = os.path.join(root, "gebench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "gebench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def derive_seed(seed: int, *path: int) -> int:
    """A seed below 2^31 for the part `path` of the run `seed`."""
    ss = np.random.SeedSequence([seed & ((1 << 64) - 1), *path])
    return int(ss.generate_state(1)[0] >> 1)


@dataclass
class Run:
    """What a run leaves for the per-layer readers: host spans (epoch us)
    of each fit's walk and train, the device operations of a traced window
    each with the span whose call launched it, the program's own spans and
    counters of the window where it recorded them, and the cell's work."""

    cell: Cell
    V: int
    E: int
    window_s: float
    spans: list  # dicts: fit, walk (start, end), train (start, end)
    ops: profiling.Ops | None = None  # a traced run's device operations
    kind: np.ndarray | None = None  # each op's launching span (label_ops)
    busy_s: float | None = None
    constants: dict = field(default_factory=dict)  # model.run_constants
    program_spans: list | None = None  # the program's ended window spans
    counters: dict | None = None  # each program counter's growth over it
    op_span: np.ndarray | None = None  # each op's innermost program span
    peaks: dict = field(default_factory=peaks)

    @property
    def fits(self) -> int:
        return len(self.spans)

    @property
    def traced(self) -> bool:
        return self.ops is not None and len(self.ops) > 0

    def span_s(self, kind) -> float:
        return sum(s[kind][1] - s[kind][0] for s in self.spans) / 1e6

    def busy_in(self, kind) -> float:
        """Seconds the device was busy with operations launched in
        `kind` spans."""
        if not self.traced:
            return 0.0
        at = self.kind == kind
        return profiling.busy_us(self.ops.start[at], self.ops.end[at]) / 1e6

    def program_ms(self, name):
        """Wall ms a fit of the program's spans named `name`; None without
        a recording, a fit or such a span."""
        if self.program_spans is None or not self.fits:
            return None
        got = [s.end - s.start for s in self.program_spans if s.name == name]
        return sum(got) / 1e6 / self.fits if got else None

    def program_busy_s(self, *names):
        """Seconds the device was busy with operations whose innermost
        program span is one of `names`; None without a trace, a recording
        or such an operation."""
        if self.op_span is None or not self.traced:
            return None
        at = np.isin(self.op_span, names)
        if not at.any():
            return None
        return profiling.busy_us(self.ops.start[at], self.ops.end[at]) / 1e6

    def _per_fit(self, count, *args):
        got = count(self.cell.config, self.V, self.E, *args)
        return None if got is None else got * self.fits

    def train_bound_s(self):
        """The trainer layer's least seconds for the window's fits: the
        larger of the model FLOPs at the card's float32 peak and the bytes
        the trainer must move at its HBM peak (for skip-gram both tables
        read and written once an epoch); None where the model counts
        either as None."""
        flops, nbytes = self.model_flops(), self.train_bytes()
        if flops is None or nbytes is None:
            return None
        return max(flops / self.peaks["fp32_flops_per_s"],
                   nbytes / self.peaks["hbm_bytes_per_s"])

    def nominal_pairs(self) -> float:
        return self._per_fit(self.cell.model.nominal_pairs)

    def model_flops(self):
        return self._per_fit(self.cell.model.model_flops, self.constants)

    def walk_bytes(self):
        return self._per_fit(self.cell.model.walk_bytes)

    def train_bytes(self):
        return self._per_fit(self.cell.model.train_bytes)


def label_ops(ops: profiling.Ops, spans):
    """Each operation's 'walk', 'train' or 'other': the span that holds
    its launch."""
    bounds = []
    for s in spans:
        bounds.append((s["walk"][0], s["walk"][1], "walk"))
        bounds.append((s["train"][0], s["train"][1], "train"))
    starts = np.array([b[0] for b in bounds] or [np.inf])
    ends = np.array([b[1] for b in bounds] or [-np.inf])
    kinds = [b[2] for b in bounds] or ["other"]
    i = np.searchsorted(starts, ops.launch, side="right") - 1
    inside = (i >= 0) & (ops.launch < ends[np.maximum(i, 0)])
    return np.where(inside, np.array(kinds)[np.maximum(i, 0)], "other")


def idle_gaps(ops: profiling.Ops, spans, t0, t1, n):
    """[label, seconds] of the n longest stretches of [t0, t1] with no
    device operation, each labelled by the host span it starts in."""
    a_all, b_all = profiling.idle_stretches(ops.start, ops.end, t0, t1)
    longest = np.argsort(a_all - b_all, kind="stable")[:n]
    out = []
    for a, b in zip(a_all[longest], b_all[longest]):
        where = "between fits"
        for s in spans:
            for kind in ("walk", "train"):
                lo, hi = s[kind]
                if lo <= a < hi:
                    where = (f"{kind} of fit {s['fit']}, "
                             f"{(a - lo) / 1e6:.4f} s in")
        out.append([where, (b - a) / 1e6])
    return out


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cell_graph(cell: Cell, device):
    """(row_ptr, col, the port's Graph) of the traffic: one graph for
    every seed, as a dataset is (a graph of its own for each seed changed
    the work: the Huffman code's depth sets the hs=1 step's shapes); the
    seed draws each fit's walks and training."""
    from graphembedding_tpu_torch import Graph

    row_ptr, col = graphgen.synthetic_csr(
        cell.traffic["nodes"], cell.traffic["avg_degree"],
        cell.traffic["graph_seed"], device)
    graph = Graph.from_csr(row_ptr.cpu().numpy(), col.cpu().numpy(),
                           directed=False)
    return row_ptr, col, graph


def warm_up(cell: Cell, graph, seed, device):
    """Set-up's whole fit, from a seed no window fit takes."""
    fit = cell.model.build(graph, cell.config, derive_seed(seed, 3), device)
    cell.model.train(fit, cell.config)
    sync(device)


@dataclass
class Window:
    spans: list  # dicts: fit, walk (start, end), train (start, end) in us
    fit_s: list
    seconds: float  # host clock, first fit's start to the last one's end
    us: tuple  # (start, end), epoch us
    kept: tuple  # (fit, seed, fit's object), drawn from the run's seed


def run_window(cell: Cell, graph, seed, seconds, device, tracer=None):
    """Whole fits until `seconds` have passed, under `tracer` where given;
    each fit kept with chance 1 / fits so far."""
    model, cfg = cell.model, cell.config
    pick = np.random.default_rng(np.random.SeedSequence(
        [seed & ((1 << 64) - 1), 1]))
    kept = None
    spans, fit_s = [], []
    if tracer:
        tracer.start()
    sync(device)
    t_start = time.perf_counter()
    us_start = time.time_ns() / 1e3
    deadline = t_start + seconds
    k = 0
    while True:
        s = derive_seed(seed, 2, k)
        a = time.time_ns() / 1e3
        fit = model.build(graph, cfg, s, device)
        sync(device)
        b = time.time_ns() / 1e3
        model.train(fit, cfg)
        sync(device)
        c = time.time_ns() / 1e3
        now = time.perf_counter()
        spans.append({"fit": k, "walk": (a, b), "train": (b, c)})
        fit_s.append((c - a) / 1e6)
        if pick.integers(0, k + 1) == 0:
            kept = (k, s, fit)
        fit = None
        k += 1
        if now >= deadline:
            break
    window = Window(spans, fit_s, now - t_start,
                    (us_start, time.time_ns() / 1e3), kept)
    if tracer:
        tracer.stop()
    return window


def take_trace(run: Run, tracer: profiling.Trace, log=print):
    """The tracer's operations into `run`, each with its host span."""
    run.ops = tracer.ops
    run.kind = label_ops(run.ops, run.spans)
    run.busy_s = profiling.busy_us(run.ops.start, run.ops.end) / 1e6
    unmatched = int(np.isnan(run.ops.launch).sum())
    log(f"trace: {len(run.ops)} device operations, {unmatched} with no "
        f"launch in the trace", file=sys.stderr)


def take_recording(run: Run, rec, before: dict, first: int):
    """The program's spans that opened in the window (from `first`) and
    the growth of its counters from `before`, into `run`; with a trace,
    each operation's innermost program span."""
    run.program_spans = [s for s in rec.spans[first:] if s.end is not None]
    run.counters = {n: v - before.get(n, 0) for n, v in rec.counters.items()}
    if run.ops is not None:
        run.op_span = profiling.op_spans(rec, run.ops)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             kind: str, started: float, log=print):
    """One run: set-up, the window, the check. Returns the result line's
    object; `started` is the host clock at the process' start."""
    cfg, model = cell.config, cell.model
    record = profiling.program_record() if trace else None
    with (record() if record else contextlib.nullcontext()) as rec:
        row_ptr, col, graph = cell_graph(cell, device)
        warm_up(cell, graph, seed, device)
        setup_s = time.perf_counter() - started
        if rec is not None:
            before, first = dict(rec.counters), len(rec.spans)
        tracer = profiling.Trace() if trace else None
        window = run_window(cell, graph, seed, seconds, device, tracer)
    V, E = cell.traffic["nodes"], int(col.shape[0])
    run = Run(cell, V, E, window.seconds, window.spans)
    if tracer:
        take_trace(run, tracer, log)
        del tracer
    if rec is not None:
        take_recording(run, rec, before, first)
        del rec
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bad_mods = forbidden_modules()
    if bad_mods:
        raise SystemExit(f"modules loaded that the benchmark may not load: "
                         f"{bad_mods}")
    fit_s = window.fit_s
    q = statistics.quantiles(fit_s, n=4) if len(fit_s) > 1 else fit_s * 3
    log(f"fits: {len(fit_s)} in {window.seconds:.4f} s; fit s median "
        f"{statistics.median(fit_s):.4f}, quartiles {q[0]:.4f} / "
        f"{q[2]:.4f}, min {min(fit_s):.4f}, max {max(fit_s):.4f}",
        file=sys.stderr)

    metrics = {}
    if not trace:
        metrics["pairs_per_s"] = {"value": run.nominal_pairs()
                                  / window.seconds, "unit": "pairs/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        run.constants = model.run_constants(cfg, row_ptr, col)
        for name, unit in cell.per_layer.items():
            v = metric_reader(name, cell.root)(run)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}

    # the check, the program's state freed but the drawn fit's outputs
    graph.free_device()
    f, s, fit = window.kept
    kept, (us_start, us_end) = model.outputs(fit), window.us
    del window, fit
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vals = model.judge(kept, s, cfg, Csr(row_ptr, col),
                       derive_seed(seed, 4, f))
    correct, shown = check.verdict(vals, cell.limits, model.CHECKS)
    log(f"checked fit {f} (seed {s}) in {time.perf_counter() - t0:.2f} s: "
        f"{vals}", file=sys.stderr)

    result = {"correct": bool(correct), "attempted": len(run.spans),
              "failed": int(not correct), "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type, "kind": kind, "count": 1,
                         "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = (us_end - us_start) / 1e6
        result["breakdown"] = {
            "device_ops": profiling.top_ops(run.ops, 10),
            "idle_gaps": idle_gaps(run.ops, run.spans, us_start, us_end,
                                   10)}
    result["check"] = shown
    return result
