"""Row gathers (K3, K5) and row scatter-adds (K2, K4): CUDA kernels and
plain versions.

K3 `gather_rows` replaces the contract of
`graphembedding_tpu/ops/pallas_scatter.py::_gather_mm_kernel` (entry
`gather_rows_matmul`): `table[ids]`. K2 `scatter_add_rows` replaces the
contract of `_rmw_kernel` (entry `scatter_add_rows`): `table.at[ids].add
(grads)` with ids outside [0, V) dropped, as XLA's scatter drops them.
K4 `scatter_add_small` replaces `_scatter_mm_kernel` (entry
`scatter_add_matmul`): K2's contract for a small table, one block per tile
of table rows and column slice (`csrc/scatter_small.cu`). K5
`dma_gather_rows` replaces `benchmarks/dma_gather.py::pallas_row_gather`:
`table[ids]` by one bulk copy per row into a ring of B-row stages, each
stage written out by one bulk store, on a persistent grid
(`csrc/dma_gather.cu`; the plan from `dma_gather_plan`).

On the H100 these kernels are bound by device-memory traffic and, at the
paths' small shapes, by latency. K3 reads each row with 16-byte loads, one
warp per row. K2 groups the ids by hand inside its one cooperative launch
(no library sort): one stable counting pass when V + 1 <= 4096, else a
stable radix sort over only bit_length(V) bits; then one warp per (unique
row, column slice), or a whole block for a long run, adds the row's
gradients in their original order (`csrc/rows.cu`). K4 makes the same sums in one
launch with no sort (`csrc/scatter_small.cu`). That is the order of the
plain version's sequential loop on the CPU, so K2, K4 and the plain
version on the CPU agree bit for bit, and the kernels are deterministic.
A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from graphembedding_tpu_torch.kernels import build as kb


def gather_rows_plain(table, ids):
    """table[ids] (int ids [N] in [0, V)) -> [N, C]."""
    return table.index_select(0, ids.long())


def scatter_add_rows_plain(table, ids, grads):
    """table[ids] += grads in place, ids outside [0, V) dropped."""
    keep = (ids >= 0) & (ids < table.shape[0])
    return table.index_add_(0, ids[keep].long(), grads[keep])


def _check_rows(table, ids, name):
    if table.dim() != 2 or table.dtype != torch.float32:
        raise ValueError(f"{name}: table must be float32 [V, C], got "
                         f"{table.dtype} {tuple(table.shape)}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise ValueError(f"{name}: ids must be int32 [N], got {ids.dtype} "
                         f"{tuple(ids.shape)}")
    if ids.device != table.device:
        raise ValueError(f"{name}: ids on {ids.device}, table on "
                         f"{table.device}")
    dev = table.device.type
    if dev not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {table.device}")
    if dev == "cuda":
        if table.stride(1) != 1:
            raise ValueError(f"{name}: table rows must be contiguous")
        if not ids.is_contiguous():
            raise ValueError(f"{name}: ids must be contiguous")
    return dev == "cuda"


def gather_rows(table, ids):
    """K3: table[ids] -> new [N, C] float32 tensor.

    `table` may be a column slice of a wider table (row stride > C).
    Callers clamp ids into [0, V) (the kernel writes zeros for an id
    outside it; the plain version raises).
    """
    if not _check_rows(table, ids, "gather_rows"):
        return gather_rows_plain(table, ids)
    lib = kb.library()
    n, c = ids.shape[0], table.shape[1]
    out = torch.empty((n, c), dtype=torch.float32, device=table.device)
    kb.check(lib.ge_gather_rows(
        table.device.index, table.data_ptr(), table.stride(0),
        table.shape[0], ids.data_ptr(), n, c, out.data_ptr(),
        kb.stream_ptr(table.device)), "gather_rows")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def _check_grads(table, ids, grads, name):
    n = ids.shape[0]
    if (grads.dtype != torch.float32 or grads.device != table.device
            or tuple(grads.shape) != (n, table.shape[1])):
        raise ValueError(
            f"{name}: grads must be float32 {(n, table.shape[1])} on "
            f"{table.device}, got {grads.dtype} {tuple(grads.shape)} on "
            f"{grads.device}")
    if grads.device.type == "cuda" and not grads.is_contiguous():
        raise ValueError(f"{name}: grads must be contiguous")


def scatter_add_rows(table, ids, grads):
    """K2: table[ids] += grads in place (ids outside [0, V) dropped),
    each row summed in the order of ids; returns table."""
    on_cuda = _check_rows(table, ids, "scatter_add_rows")
    _check_grads(table, ids, grads, "scatter_add_rows")
    if not on_cuda:
        return scatter_add_rows_plain(table, ids, grads)
    n, v = ids.shape[0], table.shape[0]
    lib = kb.library()
    # the kernel's keys, positions, counts and runs
    scratch = torch.empty(lib.ge_scatter_add_rows_scratch(n, v),
                          dtype=torch.int32, device=table.device)
    kb.check(lib.ge_scatter_add_rows(
        table.device.index, table.data_ptr(), table.stride(0),
        table.shape[0], ids.data_ptr(), grads.data_ptr(), n, table.shape[1],
        scratch.data_ptr(), kb.stream_ptr(table.device)), "scatter_add_rows")
    scatter_add_rows.launches += 1
    return table


scatter_add_rows.launches = 0


def scatter_add_small(table, ids, grads):
    """K4: K2's contract (plain version `scatter_add_rows_plain`) for a
    small table: table[ids] += grads in place, ids outside [0, V) dropped,
    each row summed in the order of ids; returns table.

    Its cost grows with N * V (every block reads all ids), so callers go
    through `scatter_add_table`, which takes it only up to SMALL_V_ROWS
    table rows.
    """
    on_cuda = _check_rows(table, ids, "scatter_add_small")
    _check_grads(table, ids, grads, "scatter_add_small")
    if not on_cuda:
        return scatter_add_rows_plain(table, ids, grads)
    kb.check(kb.library().ge_scatter_add_small(
        table.device.index, table.data_ptr(), table.stride(0),
        table.shape[0], ids.data_ptr(), grads.data_ptr(), ids.shape[0],
        table.shape[1], kb.stream_ptr(table.device)), "scatter_add_small")
    scatter_add_small.launches += 1
    return table


scatter_add_small.launches = 0

# Most table rows whose scatters go to K4. K4 reads the whole id list once
# per tile of 16 rows, so its cost grows with V while K2's does not. On an
# NVIDIA H100 (700 W) `benchmarks/scatter_bench.py --mode matmul --c 128
# --rows 6144` (LINE's ctx call) gave K4 4.258 against K2 4.819 ns/row at
# V = 16,384 and 5.871 against 4.863 at V = 24,576 (PERF.md). At C = 256,
# 45,696 rows a call K2 is the faster from V = 2,405 on; LINE never
# scatters that many rows, but the hierarchical-softmax tree scatter does
# (70,560 rows into 2,404, where K4's tile of the root rows sums them in
# order and K2 ran 16x faster; PERF.md). The rule stands until a
# benchmark sets one by rows and V.
SMALL_V_ROWS = 16_384


def scatter_add_table(table, ids, grads):
    """table[ids] += grads in place (ids outside [0, V) dropped), each row
    summed in the order of ids: K4 up to SMALL_V_ROWS table rows, K2
    above. The two are bit-equal, so the rule changes no result."""
    if table.shape[0] <= SMALL_V_ROWS:
        return scatter_add_small(table, ids, grads)
    return scatter_add_rows(table, ids, grads)


class RowOps(NamedTuple):
    """The row kernels a trainer's step runs: gather, scatter-add."""

    gather: object
    scatter_add: object


ROW_KERNELS = RowOps(gather_rows, scatter_add_table)
# the plain PyTorch versions, which the kernels are held against
ROW_PLAIN = RowOps(gather_rows_plain, scatter_add_rows_plain)


# K5's limits: 16-byte rows (the bulk copy's unit), at most 256 rows and 8
# ring slots of a stage, and one stage within the 227 KB a block may have
DMA_MAX_BLOCK_ROWS = 256
DMA_MAX_STAGES = 8
DMA_MAX_STAGE_BYTES = 227 * 1024 - 2048
# K5's plan: the 228 KB of shared memory an SM holds, less what each block
# reserves (1 KB) and keeps beside its ring (barriers, pad masks)
DMA_SMEM_PER_SM = 228 * 1024
DMA_BLOCK_RESERVE = 2048
# the most blocks an SM runs; the plan takes fewer where two stages of each
# would not fit
DMA_BLOCKS_PER_SM = 32


def dma_gather_plan(n, w, block_rows, sms, blocks_per_sm=DMA_BLOCKS_PER_SM,
                    max_stages=DMA_MAX_STAGES):
    """K5's launch plan for N ids of W-float rows, B = block_rows rows a
    stage, on a card of `sms` SMs: (stages S of each block's ring, grid,
    dynamic shared bytes a block).

    The grid is persistent: at most blocks_per_sm blocks an SM, never more
    than the N / B stages. S is the most stages (up to max_stages) that
    fit a block's share of the SM's shared memory; fewer blocks share an
    SM where two stages a block would not fit, and S = 1 where even one
    block holds only one stage. S never exceeds the stages a block takes.
    """
    stage = block_rows * w * 4
    n_stages = n // block_rows
    blocks = blocks_per_sm
    while (blocks > 1 and DMA_SMEM_PER_SM // blocks - DMA_BLOCK_RESERVE
           < 2 * stage):
        blocks -= 1
    grid = max(1, min(n_stages, blocks * sms))
    per_block = DMA_SMEM_PER_SM // blocks - DMA_BLOCK_RESERVE
    stages = max(1, min(max_stages, per_block // stage,
                        -(-n_stages // grid)))
    return stages, grid, stages * stage


@functools.lru_cache(maxsize=None)
def sm_count(device_index):
    """The SMs of a CUDA card, read once."""
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def dma_gather_rows_plain(table, ids):
    """table[ids] (int ids [N] in [0, V)) -> [N, W]."""
    return table[ids.long()]


def dma_gather_rows(table, ids, block_rows=16):
    """K5: table[ids] -> new [N, W] float32 tensor, one bulk copy per row,
    `block_rows` (B) rows a stage of a block's ring (`dma_gather_plan`).
    Requires N % B == 0 and W % 4 == 0, as the TPU benchmark did; an id
    outside [0, V) gives a zero row on the card (the plain version
    raises)."""
    on_cuda = _check_rows(table, ids, "dma_gather_rows")
    n, w = ids.shape[0], table.shape[1]
    if not 1 <= block_rows <= DMA_MAX_BLOCK_ROWS or n % block_rows:
        raise ValueError(
            f"dma_gather_rows: N = {n} must be a multiple of block_rows = "
            f"{block_rows} (1..{DMA_MAX_BLOCK_ROWS})")
    if w % 4 or block_rows * w * 4 > DMA_MAX_STAGE_BYTES:
        raise ValueError(f"dma_gather_rows: W = {w} must be a multiple of 4 "
                         f"with block_rows * W * 4 <= {DMA_MAX_STAGE_BYTES}")
    if not on_cuda:
        return dma_gather_rows_plain(table, ids)
    if not table.is_contiguous() or table.data_ptr() % 16:
        raise ValueError("dma_gather_rows: table must be contiguous and "
                         "16-byte aligned")
    plan = dma_gather_plan(n, w, block_rows, sm_count(table.device.index))
    return dma_gather_launch(table, ids, block_rows, plan)


def dma_gather_launch(table, ids, block_rows, plan):
    """Launch K5 on checked CUDA tensors with a given (stages, grid,
    shared bytes) plan; `dma_gather_rows` is the entry point, this lets
    the benchmark time other plans. Counts in `dma_gather_rows.launches`."""
    n, w = ids.shape[0], table.shape[1]
    out = torch.empty((n, w), dtype=torch.float32, device=table.device)
    kb.check(kb.library().ge_dma_gather_rows(
        table.device.index, table.data_ptr(), table.shape[0], ids.data_ptr(),
        n, w, block_rows, *plan, out.data_ptr(),
        kb.stream_ptr(table.device)), "dma_gather_rows")
    dma_gather_rows.launches += 1
    return out


dma_gather_rows.launches = 0
