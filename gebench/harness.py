"""The benchmark's run: one cell of `BENCHMARK.json`, whole fits of the
port (`graphembedding_tpu_torch`) through its public model API.

A cell names a configuration (`configs/<config>.json`: the model and its
training as a user runs it), a traffic mix (`traffic/<traffic>.json`:
the graph) and may have a file of its own (`cells/<workload>.json`: the
corpus cut to fit a window, the limits of its check). A per-layer
metric is a reader of its own (`metrics/<metric>.py`). Each is found by
its name, so a new cell, mix or metric is a new file.

Set-up: the traffic's graph, made on the device from its `graph_seed`,
handed to the port as a `Graph.from_csr`; one whole fit, which builds the graph's device views,
loads the kernels and captures the chunk graphs. Window: whole fits, each
a model built on the same `Graph` (its walks) and trained, each with a
seed of its own, each ending in a synchronize, until `seconds` have
passed; the fit in flight then runs to its end. After the window, a fit
drawn from the seed is judged by `check` against the plain reference.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from gebench import check, graphgen, profiling, work

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "graphembedding_tpu")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # as run: the configuration file with the cell's cuts
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: dict  # name -> unit of the per-layer metrics it reports
    root: str = ROOT  # the checkout whose gebench/ holds the cell's files


def _json(path):
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, end_to_end: list) -> bool:
    """Whether a per-layer metric is read in a cell: the cell is in its
    `workloads`, or it has none and the cell reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in end_to_end


def load_cell(root: str, workload: str) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json, its files found by
    the names there."""
    bench = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, conf["file"]))
    here = os.path.join(root, "gebench")
    traffic = _json(os.path.join(here, "traffic", w["traffic"] + ".json"))
    cell_file = os.path.join(here, "cells", workload + ".json")
    own = _json(cell_file) if os.path.exists(cell_file) else {}
    run_cfg = {k: v for k, v in config.items()
               if k not in ("source", "reduced", "assumed", "why")}
    run_cfg.update(own.get("corpus", {}))
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    per_layer = {m["name"]: m["unit"] for m in bench["per_layer"]
                 if reports(m, workload, e2e)}
    return Cell(workload, int(w.get("chips", 1)), run_cfg, traffic,
                own.get("limits", {}), e2e, per_layer, root)


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


def build_model(graph, cfg, seed, device):
    """The model of one fit; its constructor walks the corpus."""
    from graphembedding_tpu_torch import DeepWalk, Node2Vec

    kw = dict(walk_length=cfg["walk_length"], num_walks=cfg["num_walks"],
              seed=seed, device=device)
    if cfg["walk"] == "node2vec":
        return Node2Vec(graph, p=cfg["p"], q=cfg["q"], **kw)
    return DeepWalk(graph, **kw)


def train_model(model, cfg):
    kw = dict(embed_size=cfg["embed_size"], window_size=cfg["window_size"],
              iter=cfg["iter"], alpha=cfg["alpha"],
              min_alpha=cfg["min_alpha"], sample=cfg["sample"])
    if cfg["objective"] == "hs":
        kw["hs"] = 1
    else:
        kw["negative"] = cfg["negative"]
    model.train(**kw)


@dataclass
class Run:
    """What a run leaves for the per-layer readers: host spans (epoch us)
    of each fit's walk and train, the device operations of a traced window
    each with the span whose call launched it, and the cell's work."""

    cell: Cell
    V: int
    E: int
    window_s: float
    spans: list  # dicts: fit, walk (start, end), train (start, end)
    ops: profiling.Ops | None = None  # a traced run's device operations
    kind: np.ndarray | None = None  # each op's launching span (label_ops)
    busy_s: float | None = None
    mean_code_length: float | None = None
    peaks: dict = field(default_factory=work.peaks)

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

    def nominal_pairs(self) -> float:
        return work.nominal_pairs(self.cell.config, self.V) * self.fits

    def model_flops(self):
        fpp = work.flops_per_pair(self.cell.config, self.mean_code_length)
        return None if fpp is None else fpp * self.nominal_pairs()


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


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             kind: str, started: float, log=print):
    """One run: set-up, the window, the check. Returns the result line's
    object; `started` is the host clock at the process' start."""
    from graphembedding_tpu_torch import Graph

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cfg = cell.config
    V, deg = cell.traffic["nodes"], cell.traffic["avg_degree"]
    # one graph for every seed, as a dataset is: a graph of its own for
    # each seed changed the work (the Huffman code's depth sets the hs=1
    # step's shapes); the seed draws each fit's walks and training
    row_ptr, col = graphgen.synthetic_csr(V, deg, cell.traffic["graph_seed"],
                                          device)
    graph = Graph.from_csr(row_ptr.cpu().numpy(), col.cpu().numpy(),
                           directed=False)
    E = int(col.shape[0])
    # set-up: a whole fit from a seed no window fit takes
    model = build_model(graph, cfg, derive_seed(seed, 3), device)
    train_model(model, cfg)
    sync()
    del model
    setup_s = time.perf_counter() - started

    pick = np.random.default_rng(np.random.SeedSequence(
        [seed & ((1 << 64) - 1), 1]))
    kept = None  # (fit, seed, model): each fit kept with chance 1 / fits
    spans, fit_s = [], []
    tracer = profiling.Trace() if trace else None
    if tracer:
        tracer.start()
    sync()
    t_start = time.perf_counter()
    us_start = time.time_ns() / 1e3
    deadline = t_start + seconds
    k = 0
    while True:
        s = derive_seed(seed, 2, k)
        a = time.time_ns() / 1e3
        model = build_model(graph, cfg, s, device)
        sync()
        b = time.time_ns() / 1e3
        train_model(model, cfg)
        sync()
        c = time.time_ns() / 1e3
        now = time.perf_counter()
        spans.append({"fit": k, "walk": (a, b), "train": (b, c)})
        fit_s.append((c - a) / 1e6)
        if pick.integers(0, k + 1) == 0:
            kept = (k, s, model)
        model = None
        k += 1
        if now >= deadline:
            break
    window_s = now - t_start
    us_end = time.time_ns() / 1e3
    run = Run(cell, V, E, window_s, spans)
    if tracer:
        tracer.stop()
        run.ops = tracer.ops
        run.kind = label_ops(run.ops, spans)
        run.busy_s = profiling.busy_us(run.ops.start, run.ops.end) / 1e6
        unmatched = int(np.isnan(run.ops.launch).sum())
        log(f"trace: {len(run.ops)} device operations, {unmatched} with no "
            f"launch in the trace", file=sys.stderr)
        del tracer
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bad_mods = forbidden_modules()
    if bad_mods:
        raise SystemExit(f"modules loaded that the benchmark may not load: "
                         f"{bad_mods}")
    q = statistics.quantiles(fit_s, n=4) if len(fit_s) > 1 else fit_s * 3
    log(f"fits: {len(fit_s)} in {window_s:.4f} s; fit s median "
        f"{statistics.median(fit_s):.4f}, quartiles {q[0]:.4f} / "
        f"{q[2]:.4f}, min {min(fit_s):.4f}, max {max(fit_s):.4f}",
        file=sys.stderr)

    metrics = {}
    if not trace:
        pairs = run.nominal_pairs()
        metrics["pairs_per_s"] = {"value": pairs / window_s,
                                  "unit": "pairs/s"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    else:
        if cfg["objective"] == "hs":
            run.mean_code_length = work.mean_code_length(
                np.diff(row_ptr.cpu().numpy()))
        for name, unit in cell.per_layer.items():
            v = metric_reader(name, cell.root)(run)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}

    # the check, the program's state freed but the drawn fit's outputs
    graph.free_device()
    f, s, model = kept
    walks, w_in, w_out = model.walks, model.w_in, model.w_out
    del kept, model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    vals = check.judge(walks, w_in, w_out, s, cfg,
                       check.ref_walks.Csr(row_ptr, col),
                       derive_seed(seed, 4, f))
    correct, shown = check.verdict(vals, cell.limits)
    log(f"checked fit {f} (seed {s}) in {time.perf_counter() - t0:.2f} s: "
        f"{vals}", file=sys.stderr)

    result = {"correct": bool(correct), "attempted": len(spans),
              "failed": int(not correct), "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda"
                         else device.type, "kind": kind, "count": 1,
                         "memory_peak_bytes": int(peak)}}
    if trace:
        result["device"]["busy_s"] = run.busy_s
        result["device"]["window_s"] = (us_end - us_start) / 1e6
        result["breakdown"] = {
            "device_ops": profiling.top_ops(run.ops, 10),
            "idle_gaps": idle_gaps(run.ops, spans, us_start, us_end, 10)}
    result["check"] = shown
    return result
