"""The readers of the program's spans and counters (`metrics/`, which
`trace_cell.py`'s readings are) on a known run: hand-made spans, counters
and device operations handed to `Run` as a traced run hands them."""

import contextlib
import time

import numpy as np
import pytest
import torch
from graphembedding_tpu_torch.utils.profiling import Recording, Span

from conftest import ROOT, tiny
from gebench import harness, profiling, trace_cell

PEAKS = {"fp32_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}


def cell():
    cfg = {"num_walks": 2, "iter": 3, "walk_length": 10, "window_size": 5,
           "embed_size": 128, "negative": 5, "objective": "sgns"}
    return harness.Cell("c", 1, cfg, {}, {}, ["pairs_per_s"], {},
                        harness.model_module("Node2Vec"))


def host_spans():
    # two fits: walk 1 s then train 3 s each (us), a 1 s gap between
    return [{"fit": 0, "walk": (0.0, 1e6), "train": (1e6, 4e6)},
            {"fit": 1, "walk": (5e6, 6e6), "train": (6e6, 9e6)}]


def recording():
    """Each fit's program spans (ns): the train, its tables 0.2 s with a
    0.1 s Huffman build, its epoch preparation 0.1 s, a chunk of 2 s
    whose copies take 0.1 s each way around a 1.8 s replay."""
    rec = Recording()

    def add(name, start_s, end_s, parent=None):
        s = Span(name, parent, None, {})
        s.start, s.end = int(start_s * 1e9), int(end_s * 1e9)
        rec.spans.append(s)
        return s

    for t in (1.0, 6.0):
        train = add("train", t, t + 3)
        tables = add("train.tables", t, t + 0.2, train)
        add("train.tables.huffman", t + 0.05, t + 0.15, tables)
        add("train.prepare", t + 0.2, t + 0.3, train)
        chunk = add("chunk", t + 0.5, t + 2.5, train)
        add("chunk.copy_in", t + 0.5, t + 0.6, chunk)
        add("chunk.replay", t + 0.6, t + 2.4, chunk)
        add("chunk.copy_out", t + 2.4, t + 2.5, chunk)
    return rec


def known_run():
    run = harness.Run(cell(), V=1000, E=4000, window_s=10.0,
                      spans=host_spans(), peaks=PEAKS)
    us = 1e6
    ops = []
    for t in (1.0, 6.0):
        ops += [("counts", (t + 0.01) * us, (t + 0.06) * us, (t + 0.01) * us),
                ("prep", (t + 0.25) * us, (t + 0.45) * us, (t + 0.25) * us),
                ("copy", (t + 0.55) * us, (t + 0.65) * us, (t + 0.55) * us),
                ("step", (t + 0.7) * us, (t + 2.2) * us, (t + 0.7) * us),
                ("copy", (t + 2.45) * us, (t + 2.5) * us, (t + 2.45) * us)]
    ops.append(("lost", 9.5 * us, 9.6 * us, None))
    run.ops = profiling.Ops.from_list(ops)
    run.kind = harness.label_ops(run.ops, host_spans())
    return run


COUNTERS = {"train.steps": 128, "train.blocks": 102, "chunk.hits": 3,
            "chunk.captures": 1}
# at the window's start: a capture and the warm-up's steps of the set-up
BEFORE = {"train.steps": 64, "train.blocks": 51, "chunk.captures": 1}


def recorded_run(traced=True):
    """The known run as `run_cell` leaves it: the recording's spans from
    the window's first on, and the counters' growth from `BEFORE`."""
    run, rec = known_run(), recording()
    if not traced:
        run.ops = run.kind = None
    setup = Span("train", None, None, {})
    setup.start, setup.end = int(-2e9), int(-1e9)
    rec.spans.insert(0, setup)
    rec.counters = {n: v + BEFORE.get(n, 0) for n, v in COUNTERS.items()}
    harness.take_recording(run, rec, BEFORE, 1)
    return run


def test_readings_on_a_known_run():
    run = recorded_run()
    assert run.counters == COUNTERS
    assert run.program_spans[0].start == 1e9
    assert run.op_span.tolist() == ["train.tables", "train.prepare",
                                     "chunk.copy_in", "chunk.replay",
                                     "chunk.copy_out"] * 2 + [""]
    got = {n: harness.metric_reader(n)(run) for n in trace_cell.READINGS}
    assert trace_cell.readings(run) == got
    assert got["train.tables_ms"] == pytest.approx(200.0)
    assert got["train.huffman_ms"] == pytest.approx(100.0)
    pairs = 2 * 1000 * 3 * 46 * 2
    bound = max(pairs * 6 * 128 * 6 / 1e12, 2 * 2000 * 128 * 4 * 3 * 2 / 1e9)
    assert got["train.step_roofline"] == pytest.approx(100 * bound / 3.0)
    assert got["train.prepare_ms"] == pytest.approx(200.0)
    assert got["chunk.copy_ms"] == pytest.approx(150.0)
    assert got["train.step_use"] == pytest.approx(100 * 102 / 128)
    assert got["chunk.hit_rate"] == pytest.approx(75.0)


def test_readings_are_none_without_a_trace_or_a_recording():
    # a traced run without a recording (`--trace 0`, or a program with no
    # `record()`): the fields stay None
    run = known_run()
    assert (run.program_spans, run.counters, run.op_span) == (None,) * 3
    assert set(trace_cell.readings(run).values()) == {None}
    # spans and counters, but no device trace
    got = trace_cell.readings(recorded_run(traced=False))
    assert got["train.tables_ms"] == pytest.approx(200.0)
    assert got["chunk.hit_rate"] == pytest.approx(75.0)
    assert [got[n] for n in ("train.step_roofline", "train.prepare_ms",
                             "chunk.copy_ms")] == [None, None, None]
    # a recording with none of the spans or counters
    run.program_spans, run.counters = [], {}
    run.op_span = np.array([""] * len(run.ops))
    assert set(trace_cell.readings(run).values()) == {None}


def test_idle_gaps_name_the_innermost_program_span():
    run, rec = known_run(), recording()
    gaps = trace_cell.labelled_gaps(run, rec, 0.0, 10e6, 10)
    plain = harness.idle_gaps(run.ops, run.spans, 0.0, 10e6, 10)
    # the harness's gaps and labels, each with the program's span
    assert [g[1] for g in gaps] == [g[1] for g in plain]
    assert all(g[0].startswith(p[0]) for g, p in zip(gaps, plain))
    got = {g[0]: g[1] for g in gaps}
    assert got["train of fit 0, 2.5000 s in; train"] == pytest.approx(2.51)
    assert got["walk of fit 0, 0.0000 s in"] == pytest.approx(1.01)
    assert got["train of fit 1, 0.0600 s in; train.tables.huffman"] == \
        pytest.approx(0.19)
    assert got["train of fit 0, 2.2000 s in; chunk.replay"] == \
        pytest.approx(0.25)
    assert got["between fits"] == pytest.approx(0.4)


def test_idle_seconds_by_program_span():
    got = trace_cell.idle_by_span(known_run(), recording(), 0.0, 10e6)
    # after each fit's last copy and before each chunk (train), the walk
    # and the gap between fits (no span), the replays' tails, the builds
    assert got == pytest.approx({"train": 3.71, "(none)": 1.41,
                                 "chunk.replay": 0.6,
                                 "train.tables.huffman": 0.38})


class HostOnlyTrace:
    """`profiling.Trace` on a machine without a card: one device operation
    a host clock's instant, launched where it ran."""

    def start(self):
        self.t0 = time.time_ns() / 1e3

    def stop(self):
        t1 = time.time_ns() / 1e3
        self.ops = profiling.Ops.from_list(
            [("op", t, t + 1.0, t) for t in np.linspace(self.t0, t1, 50)])


@pytest.mark.parametrize("trace", [False, True])
def test_only_a_traced_run_records_the_program(trace, monkeypatch):
    recorded = []
    plain = profiling.program_record

    def spy():
        record = plain()

        @contextlib.contextmanager
        def watched():
            with record() as rec:
                recorded.append(rec)
                yield rec

        return watched

    monkeypatch.setattr(profiling, "program_record", spy)
    monkeypatch.setattr(profiling, "Trace", HostOnlyTrace)
    cell = tiny(harness.load_cell(ROOT, "deepwalk-hs.blogcatalog"))
    r = harness.run_cell(cell, 2**31 + 5, 0.2, trace, torch.device("cpu"),
                         "cpu", time.perf_counter(),
                         log=lambda *a, **k: None)
    assert r["correct"] is True
    assert len(recorded) == int(trace)
    if trace:
        # the program's spans and counters reach the readers
        got = {n: r["metrics"].get(n, {}).get("value")
               for n in trace_cell.READINGS}
        assert got["train.tables_ms"] > 0 and got["train.huffman_ms"] > 0
        assert 0 < got["train.step_use"] <= 100
        # no chunk graph without a card
        assert got["chunk.hit_rate"] is None
        # the whole window's spans, not the set-up's
        fits = r["attempted"]
        assert sum(s.name == "train" for s in recorded[0].spans) == fits + 1
