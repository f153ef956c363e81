"""`trace_cell.py`'s readings of the program's spans and counters on a
known run: hand-made spans, counters and device operations."""

import numpy as np
import pytest
from graphembedding_tpu_torch.utils.profiling import Recording, Span

from gebench import harness, profiling, trace_cell

PEAKS = {"fp32_flops_per_s": 1e12, "hbm_bytes_per_s": 1e9}


def cell():
    cfg = {"num_walks": 2, "iter": 3, "walk_length": 10, "window_size": 5,
           "embed_size": 128, "negative": 5, "objective": "sgns"}
    return harness.Cell("c", 1, cfg, {}, {}, ["pairs_per_s"], {})


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


def test_readings_on_a_known_run():
    run, rec = known_run(), recording()
    labels = trace_cell.op_spans(rec, run.ops)
    assert labels.tolist() == ["train.tables", "train.prepare",
                               "chunk.copy_in", "chunk.replay",
                               "chunk.copy_out"] * 2 + [""]
    got = trace_cell.readings(run, rec.spans, COUNTERS, labels)
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
    run, rec = known_run(), recording()
    assert set(trace_cell.readings(run, None, {}).values()) == {None}
    # spans and counters, but no device trace
    got = trace_cell.readings(run, rec.spans, COUNTERS)
    assert got["train.tables_ms"] == pytest.approx(200.0)
    assert [got[n] for n in ("train.step_roofline", "train.prepare_ms",
                             "chunk.copy_ms")] == [None, None, None]
    # a recording with none of the spans or counters
    empty = trace_cell.readings(run, [], {}, np.array([""] * len(run.ops)))
    assert set(empty.values()) == {None}


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
