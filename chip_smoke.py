#!/usr/bin/env python3
"""Smoke run of graphembedding_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one or more lines each:
  1. card: the name and power limit (nvidia-smi); no card -> exit 1;
  2. build: compiles the CUDA kernels from graphembedding_tpu_torch/csrc;
  3. kernels: K1 (SGNS block gradients), K2 (row scatter-add) and K3 (row
     gather) against their plain PyTorch versions at the shapes of the
     DeepWalk-on-Wiki step, with device times (CUDA events around calls
     queued while the card spins, so that host launch time does not show;
     median of 20 runs; K1 in turns with its plain version, K2 in turns
     with a bare `index_add_` on the in-range ids: other, kernel, kernel,
     other), each kernel's bound (section "Bounds" below), K1's achieved
     GB/s and useful TFLOP/s, K1's and K2's run-to-run bit identity, and
     the device launches of one K2 call (torch.profiler);
  4. step parity: four SGNS steps through the kernels against four
     through the plain versions, from the same table and draws;
  5. main path: load_dataset('wiki') -> DeepWalk(walk_length=10,
     num_walks=80, device='cuda') -> train(embed_size=128, window_size=5,
     iter=3) -> get_embeddings -> Classifier (0.8 split, seed 0); checks
     that every kernel launched and micro-F1 >= 0.93;
  6. K4 (small-V row scatter-add) against its plain version, K2 and a
     bare `index_add_` (in turns) at the shapes of the LINE-on-Wiki step:
     1,024 rows into emb and 6,144 into ctx, V = 2405, C = 128;
  7. K5 (row gather by bulk copies): the `dma_gather` benchmark at its
     default shapes (a 1M x 256 table, 65,536 ids, B = 8/16/32) against
     the plain gather, `index_select` and K3, counting K5's launches;
  8. `scatter_bench --quick`: K2 against index_add_ at V = 1M, K4, K2 and
     K3 against their plain versions at V = 2405;
  9. four LINE steps through the kernels against four plain ones;
 10. LINE path: load_dataset('wiki') -> LINE(embedding_size=128,
     order='second', device='cuda') -> train(batch_size=1024, epochs=50)
     -> get_embeddings -> Classifier; checks that K3 and K4 launched and
     micro-F1 >= 0.70.

The last three lines are the kernels' JSON record, the card line and
{"ok": true, "device": {...}}. Any failure exits non-zero before them.

Bounds: `bound_ms` is the least time the card could take for a kernel's
work on this run's inputs: the larger of its bytes (each input read once,
each output written once; for the row kernels only the rows this run's ids
touch) over 3.35 TB/s of HBM3, and its operations over the card's peak for
their type (K1: its split-TF32 products, three per useful product, at
495 TFLOP/s). `library_ms` is one PyTorch call that computes the same
function (`index_add_` on the in-range ids for K2 and K4, `index_select`
for K3 and K5; none for K1), which the port never calls.
"""

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
MIN_MICRO_F1 = 0.93  # expected of DeepWalk on the Wiki-scale graph
# LINE order 'second' on it: the JAX package gives 0.748-0.761 on the CPU
# over seeds 0-2, and the port's random streams differ from its
LINE_MIN_MICRO_F1 = 0.70
DEVICE = "cuda"


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


HBM_BYTES_PER_S = 3.35e12  # H100 SXM
TF32_FLOP_PER_S = 495e12  # H100 SXM, dense tensor cores


def rows_bound_ms(ids, V, C, out_rows):
    """Bound of a row kernel on these ids: the ids, the touched table rows
    (read, and written back when out_rows is None), and out_rows rows of
    gradients read (scatter) or of output written (gather)."""
    kept = ids[(ids >= 0) & (ids < V)]
    rows = kept.unique().numel()
    scatter = out_rows is None
    nbytes = 4 * (ids.numel() + rows * C * (2 if scatter else 1)
                  + (kept.numel() if scatter else out_rows) * C)
    return nbytes / HBM_BYTES_PER_S * 1e3


def device_launches(fn):
    """Device kernels (and copies) one call of fn ran, by torch.profiler;
    None where the trace holds no device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return names or None


def sgns_work(G, G2, PL, D, K):
    """(bytes through device memory, useful FLOP) of one K1 call: every
    input read once, every output written once; six products."""
    r = G // G2
    floats = (4 * G * PL * D + G * PL * PL + G2 * r * PL * K + 2 * G2 * K * D
              + G)
    return 4 * floats, 2 * G * D * (3 * PL * PL + 3 * PL * K)


def max_err(got, want, rtol, atol, what):
    """Max |got - want|; fails unless allclose(rtol, atol)."""
    import torch

    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{what}: non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        fail(f"{what}: {int(bad.sum())} elements outside rtol={rtol} "
             f"atol={atol}, max abs err {float(err.max()):.3e}")
    return float(err.max())


def main():
    import torch

    # 1. card
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    card = card_line()
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)

    try:
        import graphembedding_tpu_torch as pkg
    except ImportError as e:
        fail(f"graphembedding_tpu_torch not importable beside this "
             f"script: {e}")
    if not os.path.abspath(pkg.__file__).startswith(HERE + os.sep):
        fail(f"graphembedding_tpu_torch comes from {pkg.__file__}, not "
             f"from this checkout")
    from graphembedding_tpu_torch import DeepWalk
    from graphembedding_tpu_torch.benchmarks.common import (
        median_ms, turns_ms)
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.kernels import build as kb
    from graphembedding_tpu_torch.ops.rows import (
        gather_rows, gather_rows_plain, scatter_add_rows,
        scatter_add_rows_plain)
    from graphembedding_tpu_torch.ops.sgns import (
        sgns_block_grads, sgns_block_grads_plain)
    from graphembedding_tpu_torch.ops.walk import simulate_walks
    from graphembedding_tpu_torch.train import skipgram as sg

    # 2. build
    t0 = time.perf_counter()
    kb.library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{kb.build_log['seconds']} s) -> {kb.library_path()}",
          flush=True)
    for line in kb.build_log["ptxas"].splitlines():
        if "Used" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernels against plain versions at the slice's shapes
    ds = load_dataset("wiki")
    V, D, L, W, K, nsp = ds.graph.num_nodes, 128, 10, 5, 64, 4
    NW = 80 * V
    gen = torch.Generator(device=dev).manual_seed(1)
    walks = simulate_walks(ds.graph.to(dev), 80, L, generator=gen)
    if tuple(walks.shape) != (NW, L):
        fail(f"corpus shape {tuple(walks.shape)}")
    geo = sg.block_geometry(NW, L, 4032, nsp)
    w_cat = (torch.rand((V, 2 * D), generator=gen, device=dev) - 0.5) / D
    w_cat[:, D:] = torch.randn((V, D), generator=gen, device=dev) * 0.05
    eff = W - (torch.rand((4, geo.G, geo.PL), generator=gen, device=dev)
               * W).to(torch.int32).clamp(0, W - 1)
    negs = torch.randint(0, V, (4, geo.G2, K), generator=gen, device=dev,
                         dtype=torch.int32)
    window_ok, dm = sg.window_geometry(L, geo.PL, W, dev)
    tok = walks[:geo.Bw].reshape(geo.G, geo.PL)
    tok_safe, y, vn, mask, neg_ok = sg.step_inputs(
        w_cat, tok, eff[0], negs[0], window_ok, dm, nsp, ops=sg.PLAIN)
    # the gather reads pads as row 0; the scatter drops them (-1)
    flat, nflat = tok_safe.reshape(-1), negs[0].reshape(-1)
    sflat = tok.reshape(-1)
    neg_w = 5.0 / K
    print(f"shapes: V={V} NW={NW} Bw={geo.Bw} G={geo.G} PL={geo.PL} D={D} "
          f"K={K} G2={geo.G2} tokens={flat.numel()} negatives="
          f"{nflat.numel()}", flush=True)

    records = []

    def record(name, source, replaces, err, ms, plain_ms, bound_ms,
               library_ms, bound_by="bytes"):
        records.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces, launches=None,
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=library_ms))
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"kernel {name}: max_abs_err {err:.3e}, {ms:.4f} ms vs plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"library {lib} [{card}]", flush=True)

    # K3: bit-exact
    got = gather_rows(w_cat, flat)
    got_n = gather_rows(w_cat[:, D:], nflat)
    torch.cuda.synchronize()
    if not (torch.equal(got, gather_rows_plain(w_cat, flat))
            and torch.equal(got_n, gather_rows_plain(w_cat[:, D:], nflat))):
        fail("gather_rows differs from table[ids]")
    flat_l = flat.long()
    record("gather_rows", "graphembedding_tpu_torch/csrc/rows.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:261", 0.0,
           median_ms(lambda: gather_rows(w_cat, flat)),
           median_ms(lambda: gather_rows_plain(w_cat, flat)),
           rows_bound_ms(flat, V, 2 * D, flat.numel()),
           median_ms(lambda: torch.index_select(w_cat, 0, flat_l)))
    ms_n = median_ms(lambda: gather_rows(w_cat[:, D:], nflat))
    pl_n = median_ms(lambda: gather_rows_plain(w_cat[:, D:], nflat))
    print(f"  gather_rows negatives [{nflat.numel()}, {D}]: {ms_n:.4f} ms "
          f"vs plain {pl_n:.4f} ms")

    # K1: within rtol 2e-4 / atol 1e-5 of the plain version, the same bits
    # on a second launch, timed in turns with the plain version
    args = (y[..., :D], y[..., D:], vn, mask, neg_ok, neg_w)
    got = sgns_block_grads(*args)
    again = sgns_block_grads(*args)
    want = sgns_block_grads_plain(*args)
    torch.cuda.synchronize()
    err = max(max_err(g, w, 2e-4, 1e-5, f"sgns_block_grads {n}")
              for g, w, n in zip(got, want, ("d_yin", "d_yout", "d_vn",
                                             "loss")))
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail("sgns_block_grads: two launches on the same inputs differ")
    ms, plain_ms = turns_ms(lambda: sgns_block_grads(*args),
                            lambda: sgns_block_grads_plain(*args))
    nbytes, flop = sgns_work(geo.G, geo.G2, geo.PL, D, K)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = 3 * flop / TF32_FLOP_PER_S * 1e3
    record("sgns_block_grads", "graphembedding_tpu_torch/csrc/sgns.cu",
           "graphembedding_tpu/ops/pallas_sgns.py:42", err, ms, plain_ms,
           max(byte_ms, op_ms), None,
           "operations" if op_ms >= byte_ms else "bytes")
    print(f"  sgns_block_grads: run-to-run bit-identical; "
          f"{nbytes / ms / 1e6:.1f} GB/s of {nbytes / 1e6:.1f} MB a call, "
          f"{flop / ms / 1e9:.2f} useful TFLOP/s of {flop / 1e9:.2f} GFLOP "
          f"(plain: {nbytes / plain_ms / 1e6:.1f} GB/s, "
          f"{flop / plain_ms / 1e9:.2f} TFLOP/s) [{card}]", flush=True)

    # K2: held against the plain version's sequential sum on the CPU, which
    # sums each row in the same order (the plain version on the card sums
    # with atomics, in an order that changes from run to run); timed in
    # turns with a bare index_add_ on the in-range ids
    d_yin, d_yout, d_vn, _ = want
    ones = torch.ones((flat.numel(), 1), device=dev)
    d_tok = torch.cat([d_yin.reshape(-1, D), d_yout.reshape(-1, D), ones], 1)
    d_neg = torch.cat([d_vn.reshape(-1, D), ones[:nflat.numel()]], 1)
    k2 = {}
    for call, ids, grads in (("tokens", sflat, d_tok),
                             ("negatives", nflat, d_neg)):
        C = grads.shape[1]
        buf = torch.zeros((V, C), device=dev)
        got = scatter_add_rows(buf.clone(), ids, grads)
        again = scatter_add_rows(buf.clone(), ids, grads)
        want_s = scatter_add_rows_plain(buf.cpu(), ids.cpu(), grads.cpu())
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want_s) or not torch.equal(got, again):
            fail(f"scatter_add_rows {call} [{ids.numel()}, {C}]: not "
                 f"bit-equal to the CPU plain version or not run-to-run "
                 f"identical")
        keep = (ids >= 0) & (ids < V)
        ids_in, grads_in = ids[keep].long(), grads[keep].contiguous()
        ms, lib_ms = turns_ms(lambda: scatter_add_rows(buf, ids, grads),
                              lambda: buf.index_add_(0, ids_in, grads_in))
        plain_ms = median_ms(lambda: scatter_add_rows_plain(buf, ids, grads))
        launched = device_launches(lambda: scatter_add_rows(buf, ids, grads))
        launched = ("not measured" if launched is None
                    else f"{len(launched)} {launched}")
        k2[call] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                        bound_ms=rows_bound_ms(ids, V, C, None))
        print(f"  scatter_add_rows {call} [{ids.numel()}, {C}] into "
              f"[{V}, {C}]: bit-equal to the CPU plain version, run to run "
              f"identical; {ms:.4f} ms vs index_add_ {lib_ms:.4f} ms in "
              f"turns, plain {plain_ms:.4f} ms, bound "
              f"{k2[call]['bound_ms']:.4f} ms; device launches a call: "
              f"{launched} [{card}]", flush=True)
    record("scatter_add_rows", "graphembedding_tpu_torch/csrc/rows.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:67", 0.0,
           k2["tokens"]["ms"], k2["tokens"]["plain_ms"],
           k2["tokens"]["bound_ms"], k2["tokens"]["library_ms"])

    # 4. four steps through the kernels against four plain steps
    kw = dict(block_walks=4032, window=W, negative=5, neg_share_packs=nsp)
    a, la, pa = sg.sgns_block_chunk_cat(w_cat.clone(), walks, eff, negs,
                                        0.025, 1e-4, 0, 192.0, **kw)
    b, lb, pb = sg.sgns_block_chunk_cat(w_cat.clone(), walks, eff, negs,
                                        0.025, 1e-4, 0, 192.0, ops=sg.PLAIN,
                                        **kw)
    torch.cuda.synchronize()
    step_err = max_err(a, b, 1e-4, 1e-6, "four steps: table")
    max_err(la, lb, 1e-4, 1e-6, "four steps: loss")
    if not torch.equal(pa, pb):
        fail("four steps: pair counts differ")
    print(f"step parity: 4 steps, table max abs err {step_err:.3e}, "
          f"moved by {float((a - w_cat).abs().max()):.3e}", flush=True)

    # 5. the main path, counting launches
    kernels = (sgns_block_grads, scatter_add_rows, gather_rows)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = load_dataset("wiki")
    t1 = time.perf_counter()
    model = DeepWalk(ds.graph, walk_length=10, num_walks=80, device=dev)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    model.train(embed_size=128, window_size=5, iter=3)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    emb = model.get_embeddings()
    res = Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8, seed=0)
    t4 = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"main path launches: {launches}", flush=True)
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} never launched on the main path")
    for r in records:
        r["launches"] = launches[r["name"]]

    table = model.embedding_table
    if tuple(table.shape) != (V, 128) or not torch.isfinite(table).all():
        fail(f"embeddings: shape {tuple(table.shape)} or non-finite")
    if len(emb) != V:
        fail(f"get_embeddings gave {len(emb)} nodes, want {V}")
    edges = int((model.walks[:, 1:] >= 0).sum())
    walk_s, train_s = t2 - t1, t3 - t2
    print(f"main path: dataset {t1 - t0:.3f} s, walks {walk_s:.4f} s, "
          f"train {train_s:.4f} s, classify {t4 - t3:.3f} s; "
          f"final loss {float(model.losses[-1]):.4f}", flush=True)
    print(f"walked edges/s: {edges / walk_s:.4e} ({edges} edges) [{card}]")
    print(f"trained pairs/s: {model.trained_pairs / train_s:.4e} "
          f"({model.trained_pairs:.0f} pairs) [{card}]")
    print(f"micro-F1: {res['micro']:.4f}, macro-F1: {res['macro']:.4f} "
          f"[{card}]", flush=True)
    if not res["micro"] >= MIN_MICRO_F1:
        fail(f"micro-F1 {res['micro']:.4f} < {MIN_MICRO_F1}")
    if "jax" in sys.modules:
        fail("jax was imported")

    line_phases(dev, card, records, record)
    if "jax" in sys.modules or "graphembedding_tpu" in sys.modules:
        fail("jax or the JAX package was imported")

    print(json.dumps({"kernels": records}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def line_phases(dev, card, records, record):
    """Phases 6-10: K4, K5, the scatter benchmark, LINE step parity and
    the LINE path; appends the K4 and K5 records."""
    import torch

    from graphembedding_tpu_torch import LINE
    from graphembedding_tpu_torch.benchmarks import dma_gather, scatter_bench
    from graphembedding_tpu_torch.benchmarks.common import (
        median_ms, turns_ms)
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.eval.classify import Classifier
    from graphembedding_tpu_torch.models import line
    from graphembedding_tpu_torch.ops.rows import (
        dma_gather_rows, gather_rows, scatter_add_rows,
        scatter_add_rows_plain, scatter_add_small)

    # 6. K4 at the LINE step's shapes, on the step's own draws
    ds = load_dataset("wiki")
    V, D, B, K = ds.graph.num_nodes, 128, 1024, 5
    model = LINE(ds.graph, embedding_size=D, order="second", device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    h, tpos, tneg, lrs = line.line_bulk_samples(
        model._edge_src, model._edge_dst, model._edge_accept,
        model._edge_alias, model._neg_table, gen, 0.025, 0, 796.0,
        chunk_steps=4, batch_size=B, negative=K, k_shared=0)
    cases = [("emb", model.second_emb, h[0]),
             ("ctx", model.context_emb,
              torch.cat([tpos[0], tneg[0].reshape(-1)]))]
    k4 = {}
    for name, table, ids in cases:
        grads = torch.randn((ids.numel(), D), generator=gen,
                            device=dev) * 1e-3
        got = scatter_add_small(table.clone(), ids, grads)
        again = scatter_add_small(table.clone(), ids, grads)
        k2 = scatter_add_rows(table.clone(), ids, grads)
        want = scatter_add_rows_plain(table.cpu(), ids.cpu(), grads.cpu())
        torch.cuda.synchronize()
        if not (torch.equal(got.cpu(), want) and torch.equal(got, again)
                and torch.equal(got, k2)):
            fail(f"scatter_add_small [{ids.numel()}, {D}]: not bit-equal to "
                 f"the plain version on the CPU and to K2, or not run-to-run "
                 f"identical")
        buf = table.clone()
        keep = (ids >= 0) & (ids < V)
        ids_in, grads_in = ids[keep].long(), grads[keep].contiguous()
        ms, lib_ms = turns_ms(lambda: scatter_add_small(buf, ids, grads),
                              lambda: buf.index_add_(0, ids_in, grads_in))
        k4[name] = dict(
            ms=ms, library_ms=lib_ms,
            plain_ms=median_ms(lambda: scatter_add_rows_plain(buf, ids,
                                                              grads)),
            k2_ms=median_ms(lambda: scatter_add_rows(buf, ids, grads)),
            bound_ms=rows_bound_ms(ids, V, D, None))
        launched = device_launches(lambda: scatter_add_small(buf, ids, grads))
        print(f"  scatter_add_small {name} [{ids.numel()}, {D}] into "
              f"[{V}, {D}]: bit-equal to the CPU plain version and to K2; "
              f"{ms:.4f} ms vs index_add_ {lib_ms:.4f} ms in turns, plain "
              f"{k4[name]['plain_ms']:.4f} ms, K2 {k4[name]['k2_ms']:.4f} "
              f"ms, bound {k4[name]['bound_ms']:.4f} ms; device launches a "
              f"call: {'not measured' if launched is None else len(launched)}"
              f" [{card}]", flush=True)
    record("scatter_add_small",
           "graphembedding_tpu_torch/csrc/scatter_small.cu",
           "graphembedding_tpu/ops/pallas_scatter.py:315", 0.0,
           k4["ctx"]["ms"], k4["ctx"]["plain_ms"], k4["ctx"]["bound_ms"],
           k4["ctx"]["library_ms"])

    # 7. K5 through the ported dma_gather entry
    dma_gather_rows.launches = 0
    rows = dma_gather.main([])
    k5_launches = dma_gather_rows.launches
    if k5_launches == 0:
        fail("dma_gather_rows never launched in the dma_gather benchmark")
    if not all(r["equal_to_plain"] for r in rows):
        fail("dma_gather: a variant differs from table[ids]")
    by = {r["variant"]: r for r in rows}
    k5 = min((r for r in rows if r["variant"].startswith("k5")),
             key=lambda r: r["best_s"])
    # ids, the distinct rows read, the output written
    k5_bytes = 4 * (k5["rows_gathered"] * (1 + k5["width"])
                    + k5["unique_rows"] * k5["width"])
    record("dma_gather_rows", "graphembedding_tpu_torch/csrc/dma_gather.cu",
           "benchmarks/dma_gather.py:43", 0.0, k5["best_s"] * 1e3,
           by["plain"]["best_s"] * 1e3, k5_bytes / HBM_BYTES_PER_S * 1e3,
           by["index_select"]["best_s"] * 1e3)
    print(f"  dma_gather_rows: fastest {k5['variant']}; launches "
          f"{k5_launches}", flush=True)

    # 8. the scatter benchmark, quick form
    for r in scatter_bench.main(["--quick"]):
        if r.get("k4_equal_k2") is False or r.get("k3_equal") is False:
            fail(f"scatter_bench: K4/K2 or K3 disagree: {r}")
        if r.get("k2_max_abs_err", 0.0) > 1e-5:
            fail(f"scatter_bench: K2 off by {r['k2_max_abs_err']}")

    # 9. four LINE steps through the kernels against four plain ones
    outs = [line.line_steps(model.second_emb.clone(),
                            model.context_emb.clone(), h, tpos, tneg, lrs,
                            negative=K, ops=ops)
            for ops in (line.KERNELS, line.PLAIN)]
    torch.cuda.synchronize()
    errs = [max_err(a, b, 1e-5, 1e-6, f"four LINE steps: {n}")
            for a, b, n in zip(outs[0], outs[1], ("emb", "ctx", "loss"))]
    print(f"LINE step parity: 4 steps, max abs err {max(errs):.3e}, ctx "
          f"moved by "
          f"{float((outs[0][1] - model.context_emb).abs().max()):.3e}",
          flush=True)

    # 10. the LINE path, counting launches
    kernels = (gather_rows, scatter_add_small, scatter_add_rows)
    for k in kernels:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = load_dataset("wiki")
    model = LINE(ds.graph, embedding_size=D, order="second", device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model.train(batch_size=B, epochs=50)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    emb = model.get_embeddings()
    res = Classifier(emb).split_train_evaluate(ds.X, ds.Y, 0.8, seed=0)
    t3 = time.perf_counter()
    launches = {k.__name__: k.launches for k in kernels}
    print(f"LINE path launches: {launches}", flush=True)
    for name in ("gather_rows", "scatter_add_small"):
        if launches[name] == 0:
            fail(f"kernel {name} never launched on the LINE path")
    by_name = {r["name"]: r for r in records}
    by_name["scatter_add_small"]["launches"] = launches["scatter_add_small"]
    by_name["dma_gather_rows"]["launches"] = k5_launches
    table = model.embedding_table
    if tuple(table.shape) != (V, D) or not torch.isfinite(table).all():
        fail(f"LINE embeddings: shape {tuple(table.shape)} or non-finite")
    if len(emb) != V or not torch.isfinite(model.losses).all():
        fail("LINE: embeddings missing or losses non-finite")
    steps = model.losses.shape[0]
    print(f"LINE path: setup {t1 - t0:.3f} s, train {t2 - t1:.4f} s "
          f"({steps} steps of {B} edges), classify {t3 - t2:.3f} s; "
          f"final loss {float(model.losses[-1]):.4f}", flush=True)
    print(f"LINE sampled edges/s: {model.sampled_edges / (t2 - t1):.4e} "
          f"[{card}]")
    print(f"LINE micro-F1: {res['micro']:.4f}, macro-F1: "
          f"{res['macro']:.4f} [{card}]", flush=True)
    if not res["micro"] >= LINE_MIN_MICRO_F1:
        fail(f"LINE micro-F1 {res['micro']:.4f} < {LINE_MIN_MICRO_F1}")


if __name__ == "__main__":
    main()
