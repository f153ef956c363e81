"""How K4's group plan groups its ids and splits its sums, modelled in
plain torch, and the rule that picks K4's plan.

The CUDA kernel (graphembedding_tpu_torch/csrc/scatter_small.cu) groups
the ids of a scatter-add by row in one cooperative launch: each tile of
1,024 ids counts its rows (an id outside [0, V) is the dropped key V);
per key, a warp of each block of 32 keys turns the counts of its range
of tiles into counts in the tiles before, and the key's total into the
total of the keys before it in its block of 32; the blocks' totals are
scanned, and each tile places its positions, warp after warp, equal ids
in index order. Runs longer than 64 rows are listed by their length
class floor(log2(length)), class c holding at most N >> c runs. The sum
then splits the work by hits: a long run in 16-column slices (ring
units, longest class first; in a class, in the order its runs were
listed), any other run in 128-column slices (warp items), every slice
summed in index order from the table's value.

This models those steps at the kernel's widths and holds the grouping to
`np.argsort(kind="stable")`, the units to a cover of every kept (row,
column) once, and the sums, bit for bit, to the plain version's
sequential loop (`scatter_add_rows_plain`) and, within f32 rounding, to
the JAX package's `.at[].add` on the kept ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu_torch.ops import rows

# csrc/scatter_small.cu: kGTile, kWarps, kLong, kFirstClass, kClasses,
# kRingCols, and the warp items' columns (16-byte rows)
TILE, WARPS, LONG, FIRST_CLASS, CLASSES = 1024, 8, 64, 6, 32
RING_COLS, ITEM_COLS = 16, 128


def group(ids, V):
    """(positions grouped by row, run starts [V + 1], long runs by class)
    as the kernel's phases 1-3 compute them."""
    N = ids.shape[0]
    K = V + 1
    keys = torch.where((ids < 0) | (ids >= V), V, ids).long()
    T = -(-N // TILE)
    hist = torch.zeros((T, K), dtype=torch.int64)
    for t in range(T):  # 1. each tile's count of each key
        hist[t] = torch.bincount(keys[t * TILE:(t + 1) * TILE], minlength=K)
    # 2. a warp a range of tiles: the counts before each tile, per key
    per = -(-T // WARPS)
    warp_sums = torch.stack([hist[w * per:(w + 1) * per].sum(0)
                             for w in range(WARPS)])
    before_warp = torch.cumsum(warp_sums, 0) - warp_sums
    prefix = torch.empty_like(hist)
    for w in range(WARPS):
        part = hist[w * per:(w + 1) * per]
        prefix[w * per:(w + 1) * per] = (before_warp[w]
                                         + torch.cumsum(part, 0) - part)
    total = warp_sums.sum(0)
    blocks = torch.nn.functional.pad(total, (0, -K % 32)).view(-1, 32)
    key_pre = (torch.cumsum(blocks, 1) - blocks).reshape(-1)[:K]
    block_pre = torch.cumsum(blocks.sum(1), 0) - blocks.sum(1)
    start = block_pre[torch.arange(K) // 32] + key_pre
    long_runs = {}
    for k in range(V):
        if total[k] > LONG:
            c = int(total[k]).bit_length() - 1
            long_runs.setdefault(c, []).append(k)
    # 3. each tile's positions to their places, equal keys in index order
    spos = torch.full((N,), -1, dtype=torch.int64)
    for t in range(T):
        nxt = start + prefix[t]
        for i in range(t * TILE, min(N, (t + 1) * TILE)):
            k = int(keys[i])
            if k < V:
                spos[nxt[k]] = i
            nxt[k] += 1
    n_kept = int(start[V])
    return spos[:n_kept], start, long_runs


def units(start, long_runs, V, C):
    """The sum's units: ring units (row, 16-column slice) of the long runs,
    longest class first, then warp items (row, 128-column slice) of the
    other runs, in the kernel's orders."""
    ring = [(row, c0, min(c0 + RING_COLS, C))
            for c in sorted(long_runs, reverse=True) for row in long_runs[c]
            for c0 in range(0, C, RING_COLS)]
    items = [(row, c0, min(c0 + ITEM_COLS, C)) for row in range(V)
             for c0 in range(0, C, ITEM_COLS)
             if 0 < start[row + 1] - start[row] <= LONG]
    return ring, items


def make_ids(V, n, kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "huffman":  # every path through the root: hot top rows
        from graphembedding_tpu_torch.benchmarks.scatter_bench import (
            hs_path_ids)
        return hs_path_ids(V, n, seed)
    ids = rng.integers(0, V, n).astype(np.int32)
    if kind == "hot":
        ids[3::4] = ids[3]
    ids[::11], ids[1::11], ids[2::11] = -1, V, V + 100
    return ids


@pytest.mark.parametrize("V,n,kind", [(1, 100, "hot"), (7, 3000, "hot"),
                                      (2405, 6144, "uniform"),
                                      (2404, 20_000, "huffman"),
                                      (130, 9000, "huffman")])
def test_group_plan_grouping_is_a_stable_sort(V, n, kind):
    """Phases 1-3 place every kept id where a stable sort by row places
    it, and list each run longer than 64 rows in its class, class c
    holding at most N >> c runs."""
    ids = make_ids(V, n, kind, seed=V)
    spos, start, long_runs = group(torch.from_numpy(ids), V)
    kept = (ids >= 0) & (ids < V)
    order = np.argsort(np.where(kept, ids, V), kind="stable")[:kept.sum()]
    np.testing.assert_array_equal(spos.numpy(), order)
    lengths = np.bincount(ids[kept], minlength=V)
    np.testing.assert_array_equal(np.diff(start.numpy()), lengths)
    listed = sorted(k for runs in long_runs.values() for k in runs)
    assert listed == [k for k in range(V) if lengths[k] > LONG]
    for c, runs in long_runs.items():
        assert c >= FIRST_CLASS and c < CLASSES and len(runs) <= n >> c
        assert all(2 ** c <= lengths[k] < 2 ** (c + 1) for k in runs)


@pytest.mark.parametrize("V,C,n,kind", [(2404, 128, 20_000, "huffman"),
                                        (130, 40, 9000, "huffman"),
                                        (50, 7, 3000, "hot"),
                                        (2405, 256, 6144, "uniform")])
def test_group_plan_units_cover_and_sum_as_plain(V, C, n, kind):
    """Ring units and warp items cover every kept (row, column) once, the
    longest class's slices go out first, and the slices summed in index
    order from the table's value are bit-equal to the plain version (and
    within f32 rounding of the JAX package's .at[].add)."""
    ids = make_ids(V, n, kind, seed=C)
    n = ids.size
    rng = np.random.default_rng(C)
    table = rng.normal(size=(V, C)).astype(np.float32)
    grads = (rng.normal(size=(n, C)) * 1e-2).astype(np.float32)
    spos, start, long_runs = group(torch.from_numpy(ids), V)
    ring, items = units(start, long_runs, V, C)
    cover = np.zeros((V, C), np.int64)
    got = torch.from_numpy(table.copy())
    g = torch.from_numpy(grads)
    for row, c0, c1 in ring + items:
        cover[row, c0:c1] += 1
        acc = got[row, c0:c1].clone()
        for q in range(int(start[row]), int(start[row + 1])):
            acc += g[spos[q], c0:c1]
        got[row, c0:c1] = acc
    lengths = np.bincount(ids[(ids >= 0) & (ids < V)], minlength=V)
    np.testing.assert_array_equal(cover, (lengths > 0)[:, None]
                                  * np.ones((1, C), np.int64))
    if ring:  # the first unit's run is in the longest run's class
        top = int(lengths.max()).bit_length() - 1
        assert int(lengths[ring[0][0]]).bit_length() - 1 == top
    want = rows.scatter_add_rows_plain(torch.from_numpy(table.copy()),
                                       torch.from_numpy(ids), g)
    assert torch.equal(got, want)
    kept = (ids >= 0) & (ids < V)
    ref = jnp.asarray(table).at[ids[kept]].add(grads[kept])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n,v,plan", [
    (1024, 2405, "scan"), (6144, 2405, "scan"), (5040, 2405, "scan"),
    (8192, 2405, "scan"), (8193, 2405, "group"), (70_560, 2404, "group"),
    (5040, 131, "group"), (1024, 131, "scan"), (6144, 10_312, "scan"),
    (45_696, 16_384, "group"), (45_696, 16_385, "scan"),
    (1024, 1, "group")])
def test_small_plan_rule(n, v, plan):
    """K4's plan: scan up to SCAN_MAX_IDS ids and 8 ids a row on average,
    group otherwise, scan above SMALL_V_ROWS rows (no group plan there):
    LINE's calls and the HS token call take the scan plan, the HS tree
    call and Struc2Vec's token call the group plan."""
    assert rows.small_plan(n, v) == plan


def test_scatter_add_small_plan_argument():
    """On the CPU either plan is the plain version; a plan that is not
    'scan' or 'group' raises."""
    rng = np.random.default_rng(9)
    t = torch.from_numpy(rng.normal(size=(30, 8)).astype(np.float32))
    i = torch.from_numpy(rng.integers(-2, 32, 500).astype(np.int32))
    g = torch.from_numpy(rng.normal(size=(500, 8)).astype(np.float32))
    want = rows.scatter_add_rows_plain(t.clone(), i, g)
    for plan in (None, "scan", "group"):
        assert torch.equal(rows.scatter_add_small(t.clone(), i, g, plan=plan),
                           want)
    with pytest.raises(ValueError, match="plan"):
        rows.scatter_add_small(t.clone(), i, g, plan="sort")
