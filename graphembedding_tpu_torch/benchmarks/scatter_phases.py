"""Where the row scatter-adds' time goes: their phases, timed on the card.

K2 (`csrc/rows.cu::scatter_add_rows_kernel`) runs as one cooperative
launch whose phases are separated by grid barriers; K4
(`csrc/scatter_small.cu`) by one of two plans: the scan plan's blocks
stream the id list, the group plan is a cooperative launch like K2's.
This builds a copy of the kernel's source (or of `--source`) in which
block 0 reads `%globaltimer` at the kernel's start and at each phase's
end (K2: every grid barrier; K4's scan plan: its barriers set up, each id
chunk listed, each batch of staged rows landed and added; K4's group
plan: its start, then the count, the prefixes and the placement, each
ending at a grid barrier), and every block at its end (the sum's end), into
its own library under `graphembedding_tpu_torch/build/`. It runs K2 at the
DeepWalk-on-Wiki step's two scatters (the tokens of a step, [40320, 257]
with the walks' pads, and its negatives, [5376, 129], into 2,405 rows), or
K4 at the LINE-on-Wiki step's two (emb [1024, 128], ctx [6144, 128], from
LINE's own draws) and the DeepWalk hs=1 step's two (its tokens [5040, 128]
into 2,405 rows and its tree rows [70560, 128] into 2,404, from the step's
own ids), and prints one JSON line a call: the median microseconds of
each phase over `--reps` calls, the median device time a call (CUDA events
around calls queued while the card is held, as `chip_smoke.py` times),
K4's plan, ptxas's registers and spills, and the card's name and power
limit. With `--source`, each given copy is timed too, in turns with the
checkout's (other, checkout, checkout, other), and checked bit for bit
against it; a copy of K4 from before its group plan (whose C entry point
takes no scratch) runs its scan plan at every call.

    python -m graphembedding_tpu_torch.benchmarks.scatter_phases \
        [--kernel rows|small] [--reps 20] [--source variant.cu ...]

Needs a CUDA card and nvcc; exits non-zero without them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics

import torch

from graphembedding_tpu_torch.benchmarks.common import (
    median_ms,
    require_card,
    turns_ms,
)
from graphembedding_tpu_torch.kernels import build as kb
from graphembedding_tpu_torch.ops.rows import small_plan

MARKS = 16
_PRELUDE = """
#include <cuda_runtime.h>
__device__ unsigned long long ge_marks[%d];
__device__ unsigned int ge_n_marks;
__device__ __forceinline__ unsigned long long ge_now() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define GE_MARK() do { if (blockIdx.x == 0 && blockIdx.y == 0 && \\
  threadIdx.x == 0 && \\
  ge_n_marks < %d) ge_marks[ge_n_marks++] = ge_now(); } while (0)
#define GE_END() do { if (threadIdx.x == 0) \\
  atomicMax(&ge_marks[%d], ge_now()); } while (0)
extern "C" int ge_read_marks(unsigned long long* out, unsigned int* n) {
  cudaError_t e = cudaMemcpyFromSymbol(out, ge_marks, sizeof(ge_marks));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, ge_n_marks, 4);
  unsigned long long zero[%d] = {};
  unsigned int z = 0;
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ge_marks, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(ge_n_marks, &z, 4);
  return (int)e;
}
""" % (MARKS, MARKS - 1, MARKS - 1, MARKS)


def _insert(src, anchors, tail):
    """src with GE_MARK() after each anchor and GE_END() before tail."""
    for a in anchors + [tail]:
        if a not in src:
            raise ValueError(f"the kernel moved: {a.strip()!r} not found")
    for a in anchors:
        src = src.replace(a, a + "\n  GE_MARK();")
    return src.replace(tail, "\n  GE_END();" + tail, 1)


def instrument_rows(src):
    """rows.cu with marks at K2's start and after each grid barrier."""
    return _PRELUDE + _insert(
        src, ["  cg::grid_group grid = cg::this_grid();", "grid.sync();"],
        "\n}\n\ninline unsigned blocks_for")


# K4's plans: (anchors, tail) of each kernel in scatter_small.cu
_SMALL_PLANS = {
    "scan": ([
        "  const int nchunks = (N + kChunk - 1) / kChunk;",
        "  __syncthreads();  // the barriers initialised",
        "    __syncthreads();  // hits listed; warp_tot and this chunk's "
        "slot read",
        "        mbar_wait(&stage_bar[b & 1], stage_parity >> (b & 1) & 1u);",
        "      __syncthreads();  // the staged slices are read"],
        "\n}\n\n// columns a block for C split"),
    "group": (["  cg::grid_group grid = cg::this_grid();", "grid.sync();"],
              "\n}\n\n// Blocks of the group plan's grid"),
}


def instrument_small(src):
    """scatter_small.cu with marks in each plan's kernel that the source
    holds: the scan plan's start, its barriers set up, each chunk listed,
    each staged batch landed and added; the group plan's start and each
    grid barrier; and each kernel's end."""
    plans = [p for p, (_, tail) in _SMALL_PLANS.items() if tail in src]
    if not plans:
        raise ValueError("the kernel moved: no K4 plan's end found")
    for plan in plans:
        src = _insert(src, *_SMALL_PLANS[plan])
    return _PRELUDE + src


# kernel -> (source in csrc/, instrumentation, its C entry point)
KERNELS = {"rows": ("rows.cu", instrument_rows, "ge_scatter_add_rows"),
           "small": ("scatter_small.cu", instrument_small,
                     "ge_scatter_add_small")}


def build_variant(path, kernel):
    """Compile an instrumented copy of the kernel's source at path into a
    library of its own; returns it loaded."""
    with open(path) as f:
        src = KERNELS[kernel][1](f.read())
    dll, log = kb.build_text(src, "phases", kernel)
    dll.ge_read_marks.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    if not hasattr(dll, "ge_scatter_add_small_scratch") and kernel == "small":
        # the C entry point of K4 before its group plan
        dll.ge_scatter_add_small.argtypes = (
            kb.SIGNATURES["ge_scatter_add_small"][:8] + [ctypes.c_void_p])
    dll.kernel = kernel
    lines = log.splitlines()  # ptxas: the kernels' registers and spills
    dll.ptxas = [ln.strip() for i, ln in enumerate(lines)
                 if ("Used" in ln or "spill" in ln) and i > 0
                 and "scatter_add" in "".join(lines[max(0, i - 2):i])]
    return dll


def step_scatters(dev):
    """(name, ids, grads) of the DeepWalk-on-Wiki step's two K2 calls: the
    tokens of one step of 4,032 walks (pads -1) and its negatives."""
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.ops.walk import simulate_walks

    graph = load_dataset("wiki").graph
    V, L, Bw, D = graph.num_nodes, 10, 4032, 128
    gen = torch.Generator(device=dev).manual_seed(1)
    walks = simulate_walks(graph, 80, L, generator=gen)
    tok = walks[:Bw].reshape(-1).contiguous()
    neg = torch.randint(0, V, (84 * 64,), generator=gen, device=dev,
                        dtype=torch.int32)
    return V, [(name, ids, torch.randn((ids.numel(), c), generator=gen,
                                       device=dev) * 1e-3)
               for name, ids, c in (("tokens", tok, 2 * D + 1),
                                    ("negatives", neg, D + 1))]


def line_scatters(dev):
    """(V, [(name, ids, grads)]) of the LINE-on-Wiki step's two K4 calls,
    on LINE's own draws: 1,024 rows into emb, 6,144 into ctx."""
    from graphembedding_tpu_torch import LINE
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.models import line

    graph = load_dataset("wiki").graph
    m = LINE(graph, embedding_size=128, order="second", device=dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    h, tpos, tneg, _ = line.line_bulk_samples(
        m._edge_src, m._edge_dst, m._edge_accept, m._edge_alias,
        m._neg_table, gen, 0.025, 0, 796.0, chunk_steps=1, batch_size=1024,
        negative=5, k_shared=0)
    calls = [("emb", h[0].contiguous()),
             ("ctx", torch.cat([tpos[0], tneg[0].reshape(-1)]))]
    return graph.num_nodes, [(name, ids, torch.randn(
        (ids.numel(), 128), generator=gen, device=dev) * 1e-3)
        for name, ids in calls]


def hs_scatters(dev):
    """[(name, V, ids, grads)] of the DeepWalk hs=1 Wiki step's two K4
    calls, as its first step makes them (window draws and tables from a
    seed): the tokens [5040, 128] into 2,405 rows (pads -1) and the tree
    rows [70560, 128] into 2,404 (the Huffman paths of the tokens' walks,
    pads -1)."""
    from graphembedding_tpu_torch.data import load_dataset
    from graphembedding_tpu_torch.ops.rows import scatter_add_rows_plain
    from graphembedding_tpu_torch.ops.walk import simulate_walks
    from graphembedding_tpu_torch.train import hsoftmax as hs
    from graphembedding_tpu_torch.train import skipgram as sg

    graph = load_dataset("wiki").graph
    V, D, L, W = graph.num_nodes, 128, 10, 5
    gen = torch.Generator(device=dev).manual_seed(13)
    walks = simulate_walks(graph, 80, L, generator=gen)
    geo = sg.block_geometry(walks.shape[0], L,
                            sg.fit_block_walks(walks.shape[0], L, 504), 1)
    points, codes, _ = hs.build_huffman(sg.corpus_counts(walks, V))
    points = torch.as_tensor(points, device=dev)
    codes = torch.as_tensor(codes, device=dev)
    eff = W - (torch.rand((geo.G, geo.PL), generator=gen, device=dev)
               * W).to(torch.int32).clamp(0, W - 1)
    ok, dm = sg.window_geometry(L, geo.PL, W, dev)
    seen = []

    def keep(table, ids, grads):
        seen.append((table.shape[0], ids.clone(), grads.clone()))
        return scatter_add_rows_plain(table, ids, grads)

    hs.hs_step((torch.rand((V, D), generator=gen, device=dev) - 0.5) / D,
               torch.randn((V - 1, D), generator=gen, device=dev) * 0.05,
               walks[:geo.Bw].reshape(geo.G, geo.PL), eff, points, codes,
               0.025, window_ok=ok, dm=dm, update_cap=8.0,
               ops=hs.PLAIN._replace(scatter_add=keep))
    return [(name, *call) for name, call in zip(("hs token", "hs tree"),
                                                seen)]


def run(dll, table, ids, grads):
    args = (table.device.index, table.data_ptr(), table.stride(0),
            table.shape[0], ids.data_ptr(), grads.data_ptr(), ids.numel(),
            table.shape[1])
    stream = kb.stream_ptr(table.device)
    if dll.kernel == "small":
        if not hasattr(dll, "ge_scatter_add_small_scratch"):  # scan only
            kb.check(dll.ge_scatter_add_small(*args, stream), "K4 (phases)")
            return table
        group = small_plan(ids.numel(), table.shape[0]) == "group"
        scratch = torch.empty(
            dll.ge_scatter_add_small_scratch(ids.numel(), table.shape[0])
            if group else 0, dtype=torch.int32, device=table.device)
        kb.check(dll.ge_scatter_add_small(
            *args, scratch.data_ptr() if group else None, group, stream),
            "K4 (phases)")
        return table
    scratch = torch.empty(
        dll.ge_scatter_add_rows_scratch(ids.numel(), table.shape[0]),
        dtype=torch.int32, device=table.device)
    kb.check(dll.ge_scatter_add_rows(*args, scratch.data_ptr(), stream),
             "K2 (phases)")
    return table


def phase_us(dll, table, ids, grads, reps):
    """Median microseconds of each phase: start -> each barrier -> the
    last block's end."""
    marks = (ctypes.c_uint64 * MARKS)()
    n = ctypes.c_uint(0)
    torch.cuda.synchronize()
    kb.check(dll.ge_read_marks(ctypes.addressof(marks), ctypes.addressof(n)),
             "marks")  # clears the marks of earlier calls
    spans = []
    for _ in range(reps):
        run(dll, table, ids, grads)
        torch.cuda.synchronize()
        kb.check(dll.ge_read_marks(ctypes.addressof(marks),
                                   ctypes.addressof(n)), "marks")
        t = [marks[i] for i in range(n.value)] + [marks[MARKS - 1]]
        spans.append([(b - a) / 1e3 for a, b in zip(t, t[1:])])
    return [statistics.median(s[i] for s in spans)
            for i in range(len(spans[0]))]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernel", default="rows", choices=sorted(KERNELS))
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--source", nargs="*", default=[])
    return p.parse_args(argv)


def main(argv=None):
    """Time the phases at the step's two calls; returns the JSON records."""
    args = parse_args(argv)
    dev, card = require_card()
    if args.kernel == "rows":
        V, calls = step_scatters(dev)
        calls = [(name, V, ids, grads) for name, ids, grads in calls]
    else:
        V, calls = line_scatters(dev)
        calls = ([(name, V, ids, grads) for name, ids, grads in calls]
                 + hs_scatters(dev))
    base = build_variant(os.path.join(kb.CSRC, KERNELS[args.kernel][0]),
                         args.kernel)
    variants = [(path, build_variant(path, args.kernel))
                for path in args.source]
    results = []
    for name, V, ids, grads in calls:
        table = torch.zeros((V, grads.shape[1]), device=dev)
        want = run(base, table.clone(), ids, grads)
        equal = [torch.equal(run(dll, table.clone(), ids, grads), want)
                 for _, dll in variants]
        r = {"call": name, "rows": ids.numel(), "c": grads.shape[1], "v": V,
             "phases_us": phase_us(base, table, ids, grads, args.reps),
             "ms": median_ms(lambda: run(base, table, ids, grads)),
             "ptxas": base.ptxas, "card": card}
        if args.kernel == "small":
            r["plan"] = small_plan(ids.numel(), V)
        for (path, dll), same in zip(variants, equal):
            ms, base_ms = turns_ms(lambda: run(dll, table, ids, grads),
                                   lambda: run(base, table, ids, grads))
            r.setdefault("variants", []).append({
                "source": path, "equal": same, "ms": ms,
                "checkout_ms": base_ms, "ptxas": dll.ptxas,
                "phases_us": phase_us(dll, table, ids, grads, args.reps)})
        print(json.dumps(r), flush=True)
        results.append(r)
    return results


if __name__ == "__main__":
    main()
