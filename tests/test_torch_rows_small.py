"""Port's small-V scatter-add (K4) and bulk-copy row gather (K5) against
the JAX package.

K4's plain path (`scatter_add_small` on CPU tensors) against the Pallas
`scatter_add_matmul(..., interpret=True, split=2)`: atol=5e-3, the bound of
its bf16x2 operand split (tests/test_pallas_scatter.py); against
`table.at[ids].add`: rtol=atol=1e-5 (exact f32 sums in another order).
Ids outside [0, V) are dropped, as the Pallas kernel drops them.

K5's plain path against the JAX benchmark's own oracle `table[ids]`,
bit-equal. `benchmarks/dma_gather.py::pallas_row_gather` itself cannot
run here: it has no interpret switch and waits on TPU DMA semaphores.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphembedding_tpu.ops.pallas_scatter import scatter_add_matmul
from graphembedding_tpu_torch.ops.rows import (
    DMA_BLOCK_RESERVE,
    DMA_BLOCKS_PER_SM,
    DMA_MAX_STAGES,
    DMA_SMEM_PER_SM,
    dma_gather_plan,
    dma_gather_rows,
    dma_gather_rows_plain,
    scatter_add_rows_plain,
    scatter_add_small,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_case(v, c, n, seed, id_range=None):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, c)).astype(np.float32)
    ids = rng.integers(0, id_range or v, size=n).astype(np.int32)
    grads = (rng.normal(size=(n, c)) * 0.1).astype(np.float32)
    return table, ids, grads


def k4(table, ids, grads):
    return scatter_add_small(torch.from_numpy(table.copy()),
                             torch.from_numpy(ids),
                             torch.from_numpy(grads)).numpy()


@pytest.mark.parametrize("case", ["uniform", "duplicates", "out_of_range"])
def test_scatter_add_small_matches_pallas_matmul(case):
    v, c, n = 300, 128, 2500
    table, ids, grads = make_case(v, c, n, seed=1,
                                  id_range=7 if case == "duplicates" else
                                  None)
    if case == "out_of_range":
        ids[::9] = -1
        ids[1::9] = v
        ids[2::9] = v + 100
    got = k4(table, ids, grads)
    want = scatter_add_matmul(jnp.asarray(table), jnp.asarray(ids),
                              jnp.asarray(grads), block=1024, split=2,
                              interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=5e-3)
    # exact f32 reference, with the dropped ids taken out (JAX's .at[]
    # would wrap -1 numpy-style; the Pallas kernel and K4 drop it)
    keep = (ids >= 0) & (ids < v)
    exact = jnp.asarray(table).at[ids[keep]].add(grads[keep])
    np.testing.assert_allclose(got, np.asarray(exact), rtol=1e-5, atol=1e-5)
    if case == "out_of_range":
        # XLA's scatter drops ids >= V, so those need no filtering
        hi = ids >= 0
        np.testing.assert_allclose(
            got, np.asarray(jnp.asarray(table).at[ids[hi]].add(grads[hi])),
            rtol=1e-5, atol=1e-5)


def test_scatter_add_small_is_k2s_plain_version():
    """K4's contract is K2's: on the CPU both are the one plain version,
    summing each row in index order (the order K4 keeps on the card)."""
    table, ids, grads = make_case(40, 6, 700, seed=2, id_range=45)
    want = scatter_add_rows_plain(torch.from_numpy(table.copy()),
                                  torch.from_numpy(ids),
                                  torch.from_numpy(grads)).numpy()
    np.testing.assert_array_equal(k4(table, ids, grads), want)
    ref = table.copy()
    for i, g in zip(ids, grads):  # the sequential sum, row by row
        if i < 40:
            ref[i] += g
    np.testing.assert_array_equal(want, ref)


def test_scatter_add_small_checks_inputs():
    table, ids, grads = make_case(16, 8, 10, seed=3)
    t, i, g = map(torch.from_numpy, (table, ids, grads))
    with pytest.raises(ValueError):
        scatter_add_small(t, i.long(), g)
    with pytest.raises(ValueError):
        scatter_add_small(t, i, g[:, :4])
    with pytest.raises(ValueError):
        scatter_add_small(t.double(), i, g)


@pytest.mark.parametrize("block_rows", [8, 16, 32])
def test_dma_gather_plain_matches_jax_oracle(block_rows):
    table, ids, _ = make_case(1000, 64, 256, seed=4)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(ids)])
    got = dma_gather_rows(torch.from_numpy(table), torch.from_numpy(ids),
                          block_rows=block_rows)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        dma_gather_rows_plain(torch.from_numpy(table),
                              torch.from_numpy(ids)).numpy(), want)


def test_dma_gather_checks_inputs():
    table, ids, _ = make_case(100, 64, 48, seed=5)
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    with pytest.raises(ValueError):  # N % B != 0, as the TPU kernel asserts
        dma_gather_rows(t, i, block_rows=32)
    with pytest.raises(ValueError):  # rows of 16-byte units only
        dma_gather_rows(t[:, :62], i, block_rows=16)
    with pytest.raises(ValueError):  # staging beyond a block's shared memory
        dma_gather_rows(torch.zeros((10, 2048)), i, block_rows=48)
    with pytest.raises(ValueError):
        dma_gather_rows(t, i.long(), block_rows=16)


# the benchmark's default shape at each B, the DeepWalk gather's, a stage
# too large to fit twice, fewer stages than blocks, one row a stage, 256
# rows of 16 bytes; on an H100 (132 SMs) and on a small card
@pytest.mark.parametrize("n,w,b", [(1 << 16, 256, 8), (1 << 16, 256, 16),
                                   (1 << 16, 256, 32), (40320, 256, 16),
                                   (64, 2048, 16), (160, 256, 16),
                                   (3001, 8, 1), (256 * 600, 4, 256)])
@pytest.mark.parametrize("sms", [132, 4])
def test_dma_gather_plan(n, w, b, sms):
    """K5's launch plan: S >= 1 ring stages that fit a block's share of an
    SM's shared memory, a grid of at most N / B blocks, and S no larger
    than the stages a block takes."""
    stages, grid, smem = dma_gather_plan(n, w, b, sms)
    stage = b * w * 4
    assert 1 <= stages <= DMA_MAX_STAGES and smem == stages * stage
    assert 1 <= grid <= min(n // b, DMA_BLOCKS_PER_SM * sms)
    # within a block's 227 KB, and the blocks an SM gets fit beside it
    assert smem + 1024 <= 227 * 1024
    per_sm = DMA_SMEM_PER_SM // (smem + DMA_BLOCK_RESERVE)
    assert per_sm >= min(DMA_BLOCKS_PER_SM, -(-grid // sms))
    assert stages <= -(-(n // b) // grid)
    if stage * 2 > DMA_SMEM_PER_SM - DMA_BLOCK_RESERVE:
        assert stages == 1  # W = 2048, B = 16: one 128 KB stage
    if (w, b) == (256, 16) and n == 1 << 16:
        # the benchmark's shape: six blocks an SM, two stages of 16 KB each
        assert (stages, grid) == (2, min(n // b, 6 * sms))


@pytest.mark.parametrize("module", ["dma_gather", "scatter_bench"])
def test_benchmarks_need_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the benchmark runs for real")
    args = {"dma_gather": ["--reps", "1"], "scatter_bench": ["--quick"]}
    out = subprocess.run(
        [sys.executable, "-m", f"graphembedding_tpu_torch.benchmarks.{module}",
         *args[module]], cwd=ROOT, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert "needs a CUDA card" in out.stderr
    assert out.stdout == ""
