"""A traced window of one cell with the program's own spans recorded:

    python3 gebench/trace_cell.py --workload <name> --seed <n>
        --seconds <s> [--record 0|1] [--out <file>]

The set-up and the window of `harness.run_cell`, made by its functions,
under the device trace (`profiling.Trace`), with the program's
`graphembedding_tpu_torch.utils.profiling.record()` on around both
(`--record 1`, where the program has it). No check and no result line of
`run.py`: prints on standard error the split of set-up into imports,
graph, views, kernel load, captures and the rest of the warm-up fit, and
as the last line of standard output one JSON object: the fits' times,
the cell's per-layer metrics (`metrics/`), the `readings` below, device
seconds by innermost program span, the heaviest operations split by it,
the idle gaps labelled as `harness.idle_gaps` labels them, each with
the innermost program span open at its start, and the idle seconds by
that span.

`readings`: the per-layer metrics that read the program's recording,
each by its reader (`metrics/<name>.py`), which `run.py --trace 1`
reports too; of the window's spans and the counters' growth over it, "a
fit" being one of the window's fits:
- train.tables_ms, train.huffman_ms: wall ms a fit of `train.tables`
  and `train.tables.huffman` (host clock);
- train.step_roofline (%): `train.roofline`'s bound over the device time
  launched in `chunk.replay`;
- train.prepare_ms: device ms a fit launched in `train.prepare` and
  `train.draws`;
- chunk.copy_ms: device ms a fit launched in `chunk.copy_in` and
  `chunk.copy_out`;
- train.step_use (%): 100 x `train.blocks` / `train.steps`;
- chunk.hit_rate (%): 100 x `chunk.hits` / (hits + `chunk.captures`).
Each is None where there is nothing to read: no recording, no trace, or
no such span or counter.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READINGS = ("train.tables_ms", "train.huffman_ms", "train.step_roofline",
            "train.prepare_ms", "chunk.copy_ms", "train.step_use",
            "chunk.hit_rate")


def readings(run):
    """The readings of the module's docstring, each by its reader
    (`metrics/<name>.py`) on the run's program spans, counters and
    operations' innermost spans."""
    from gebench import harness

    return {n: harness.metric_reader(n)(run) for n in READINGS}


def labelled_gaps(run, rec, t0, t1, n):
    """`harness.idle_gaps` of the trace, each label followed by '; ' and
    the innermost program span open at the gap's start, where one is."""
    from gebench import harness, profiling

    gaps = harness.idle_gaps(run.ops, run.spans, t0, t1, n)
    a, b = profiling.idle_stretches(run.ops.start, run.ops.end, t0, t1)
    starts = a[np.argsort(a - b, kind="stable")[:n]]
    at = rec.innermost(np.round(starts * 1e3).astype(np.int64))
    return [[label + (f"; {rec.spans[i].name}" if i >= 0 else ""), s]
            for (label, s), i in zip(gaps, at)]


def idle_by_span(run, rec, t0, t1):
    """Seconds of [t0, t1] with no device operation running, summed by
    the innermost program span open where each idle stretch starts."""
    from gebench import profiling

    a, b = profiling.idle_stretches(run.ops.start, run.ops.end, t0, t1)
    at = rec.innermost(np.round(a * 1e3).astype(np.int64))
    out = {}
    for i, s in zip(at, (b - a) / 1e6):
        name = rec.spans[i].name if i >= 0 else "(none)"
        out[name] = out.get(name, 0.0) + float(s)
    return dict(sorted(out.items(), key=lambda x: -x[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import graphembedding_tpu_torch  # noqa: F401

    from gebench import harness, profiling

    imports_s = time.perf_counter() - STARTED
    cell = harness.load_cell(ROOT, args.workload)
    device, card = profiling.require_card(cell.chips)
    record = profiling.program_record() if args.record else None
    out = {"cell": cell.name, "seed": args.seed, "card": card,
           "record": record is not None}

    with (record() if record else contextlib.nullcontext()) as rec:
        t = time.perf_counter()
        row_ptr, col, graph = harness.cell_graph(cell, device)
        graph_s = time.perf_counter() - t
        t = time.perf_counter()
        harness.warm_up(cell, graph, args.seed, device)
        warm_s = time.perf_counter() - t
        split = {"setup_s": time.perf_counter() - STARTED,
                 "imports_s": imports_s, "graph_s": graph_s,
                 "warmup_fit_s": warm_s}
        if rec is not None:
            parts = {"views_s": rec.wall_s("graph.view"),
                     "kernels_load_s": rec.wall_s("kernels.load"),
                     "captures_s": rec.wall_s("chunk.capture")}
            split.update(parts, captures=rec.counters.get("chunk.captures"),
                         warmup_rest_s=warm_s - sum(parts.values()))
            before, first = dict(rec.counters), len(rec.spans)
        out["setup"] = split
        print("set-up: " + json.dumps(split), file=sys.stderr, flush=True)
        tracer = profiling.Trace()
        window = harness.run_window(cell, graph, args.seed, args.seconds,
                                    device, tracer)
    fit_s, (us_start, us_end) = window.fit_s, window.us
    q = statistics.quantiles(fit_s, n=4) if len(fit_s) > 1 else fit_s * 3
    out.update(fits=len(fit_s), window_s=window.seconds, fit_s={
        "median": statistics.median(fit_s), "q1": q[0], "q3": q[2],
        "min": min(fit_s), "max": max(fit_s)})
    run = harness.Run(cell, cell.traffic["nodes"], int(col.shape[0]),
                      window.seconds, window.spans)
    del window
    out["pairs_per_s"] = run.nominal_pairs() / run.window_s
    harness.take_trace(run, tracer)
    if rec is not None:
        harness.take_recording(run, rec, before, first)
    run.constants = cell.model.run_constants(cell.config, row_ptr, col)
    out["busy_s"] = run.busy_s
    out["metrics"] = {n: harness.metric_reader(n)(run)
                      for n in cell.per_layer}
    out["readings"] = readings(run)
    if rec is None:
        out["idle_gaps"] = harness.idle_gaps(run.ops, run.spans, us_start,
                                             us_end, 10)
    else:
        labels = run.op_span
        out["counters"] = run.counters
        by = {}
        for s in run.program_spans:
            by[s.name] = by.get(s.name, 0.0) + (s.end - s.start) / 1e9
        out["span_wall_s"] = by
        out["device_s_by_span"] = {
            n or "(none)": profiling.busy_us(run.ops.start[labels == n],
                                             run.ops.end[labels == n]) / 1e6
            for n in np.unique(labels)}
        dur = run.ops.end - run.ops.start
        top = []
        heavy = np.argsort(-np.bincount(run.ops.name, weights=dur,
                                        minlength=len(run.ops.names)))
        for i in heavy[:12]:
            at = run.ops.name == i
            top.append([run.ops.names[i][:90], float(dur[at].sum()) / 1e6,
                        {n or "(none)": float(dur[at & (labels == n)].sum())
                         / 1e6 for n in np.unique(labels[at])}])
        out["top_ops"] = top
        out["idle_gaps"] = labelled_gaps(run, rec, us_start, us_end, 10)
        out["idle_s_by_span"] = idle_by_span(run, rec, us_start, us_end)
    print(f"fits: {len(fit_s)} in {run.window_s:.4f} s; {out['fit_s']}",
          file=sys.stderr, flush=True)
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


if __name__ == "__main__":
    main()
