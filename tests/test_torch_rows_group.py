"""How K2 groups its ids, modelled in plain torch.

The CUDA kernel (graphembedding_tpu_torch/csrc/rows.cu) groups the ids of
a scatter-add with no library sort: each id outside [0, V) becomes the key
V (a bucket after every row, dropped), and stable counting passes move
the keys and their int32 positions: one pass over whole keys where V + 1
<= 4096, else an LSD radix over bit_length(V) bits in passes of at most
8 bits of equal width. A pass counts the digits of each tile of 1,024
keys, places the keys of digit d from tile t after every key of a smaller
digit and after the keys of digit d in earlier tiles, and ranks a key in
its tile among keys of the same digit in index order. Run starts are then
the kept keys that differ from their left neighbour, and each row is
summed from its table value in the order of its positions.

This models those passes at the kernel's tile and digit widths and holds
the grouping to `np.argsort(kind="stable")` and `torch.sort(stable=True)`,
and the sums, bit for bit, to the plain version's sequential loop
(`scatter_add_rows_plain`) and to the JAX package's `.at[].add` on the
kept ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu_torch.ops.rows import scatter_add_rows_plain

# csrc/rows.cu: kTile, kMaxDigitBits, kSmallKeys
TILE, MAX_DIGIT_BITS, SMALL_KEYS = 1024, 8, 4096


def passes_of(V):
    """(passes, digit bits) for keys 0 .. V, as the kernel's launch picks
    them; (0, 0) for its one pass over whole keys."""
    if V + 1 <= SMALL_KEYS:
        return 0, 0
    bits = int(V).bit_length()
    passes = -(-bits // MAX_DIGIT_BITS)
    return passes, -(-bits // passes)


def counting_pass(keys, pos, digit, R):
    """One stable counting pass over digits in [0, R), tile by tile."""
    n = keys.shape[0]
    tiles = -(-n // TILE)
    tile_of = torch.arange(n) // TILE
    hist = torch.zeros((tiles, R), dtype=torch.int64)
    hist.index_put_((tile_of, digit), torch.ones(n, dtype=torch.int64),
                    accumulate=True)
    # digit-major exclusive scan: offset of (tile t, digit d)
    flat = hist.T.reshape(-1)
    offset = (torch.cumsum(flat, 0) - flat).reshape(R, tiles).T
    rank = torch.empty(n, dtype=torch.int64)
    for t in range(tiles):  # keys of the same digit in index order
        sl = slice(t * TILE, (t + 1) * TILE)
        onehot = torch.nn.functional.one_hot(digit[sl], R)
        before = torch.cumsum(onehot, 0) - onehot
        rank[sl] = before.gather(1, digit[sl, None])[:, 0]
    dest = offset[tile_of, digit] + rank
    new_keys = torch.empty_like(keys)
    new_pos = torch.empty_like(pos)
    new_keys[dest] = keys
    new_pos[dest] = pos
    return new_keys, new_pos


def group(ids, V):
    """The kernel's grouping: (sorted keys, int32 positions, run starts,
    number of kept keys)."""
    keys = torch.where((ids < 0) | (ids >= V), V, ids).to(torch.int32)
    pos = torch.arange(ids.shape[0], dtype=torch.int32)
    passes, dbits = passes_of(V)
    if passes == 0:
        keys, pos = counting_pass(keys, pos, keys.long(), V + 1)
    for p in range(passes):
        digit = (keys >> (p * dbits)) & ((1 << dbits) - 1)
        keys, pos = counting_pass(keys, pos, digit.long(), 1 << dbits)
    kept = keys < V
    prev = torch.cat([torch.tensor([-1], dtype=torch.int32), keys[:-1]])
    starts = torch.nonzero(kept & (keys != prev))[:, 0].to(torch.int32)
    return keys, pos, starts, int(kept.sum())


def segment_sum(table, grads, keys, pos, starts, n_kept):
    """table[row] += the run's gradient rows, each row from its table value
    in the order of its positions (vectorised over runs)."""
    ends = torch.cat([starts[1:], torch.tensor([n_kept], dtype=torch.int32)])
    rows = keys[starts.long()].long()
    acc = table[rows].clone()
    for step in range(int((ends - starts).max()) if len(starts) else 0):
        live = starts + step < ends
        acc[live] += grads[pos[(starts + step)[live].long()].long()]
    table[rows] = acc
    return table


def make_ids(V, n, hot, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, n).astype(np.int32)
    if hot:
        ids[3::4] = ids[3]
    ids[::11], ids[1::11], ids[2::11] = -1, V, V + 100
    return ids


@pytest.mark.parametrize("V", [1, 7, 2405, 1 << 20])
@pytest.mark.parametrize("hot", [False, True])
def test_grouping_is_a_stable_sort(V, hot):
    """The passes place every key where a stable sort of the keys (ids
    outside [0, V) as V) places it, with the same int32 positions."""
    n = 5376 if V < (1 << 20) else 45_696
    ids = make_ids(V, n, hot, seed=V % 97)
    keys, pos, starts, n_kept = group(torch.from_numpy(ids), V)
    assert pos.dtype == torch.int32 and keys.dtype == torch.int32
    as_keys = np.where((ids < 0) | (ids >= V), V, ids)
    order = np.argsort(as_keys, kind="stable")
    np.testing.assert_array_equal(pos.numpy(), order)
    np.testing.assert_array_equal(keys.numpy(), as_keys[order])
    t_keys, t_pos = torch.sort(torch.from_numpy(as_keys), stable=True)
    assert torch.equal(pos.long(), t_pos)
    assert torch.equal(keys.long(), t_keys.long())
    kept = (ids >= 0) & (ids < V)
    assert n_kept == int(kept.sum())
    assert len(starts) == len(np.unique(ids[kept]))


@pytest.mark.parametrize("V,C", [(1, 5), (7, 33), (2405, 129)])
def test_grouped_sums_equal_plain(V, C):
    """Runs summed from the grouping are bit-equal to the plain version's
    sequential sum and within f32 rounding of the JAX package's .at[].add;
    ids -1, V and V + 100 are dropped."""
    rng = np.random.default_rng(C)
    ids = make_ids(V, 3000, True, seed=C)
    table = rng.normal(size=(V, C)).astype(np.float32)
    grads = (rng.normal(size=(3000, C)) * 1e-2).astype(np.float32)
    got = segment_sum(torch.from_numpy(table.copy()), torch.from_numpy(grads),
                      *group(torch.from_numpy(ids), V))
    want = scatter_add_rows_plain(torch.from_numpy(table.copy()),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(grads))
    assert torch.equal(got, want)
    kept = (ids >= 0) & (ids < V)
    ref = jnp.asarray(table).at[ids[kept]].add(grads[kept])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
