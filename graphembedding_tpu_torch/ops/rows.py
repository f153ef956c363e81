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
`table[ids]` by one bulk copy per row, B rows a block
(`csrc/dma_gather.cu`).

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

    Its cost grows with N * V (every block reads all ids), so callers use
    it only up to a number of table rows (`models/line.py::SMALL_V_ROWS`).
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

# K5's limits: 16-byte rows (the bulk copy's unit) and B rows of the block's
# shared-memory staging within the 227 KB a block may have
DMA_MAX_BLOCK_ROWS = 256
DMA_MAX_STAGE_BYTES = 227 * 1024 - 2048


def dma_gather_rows_plain(table, ids):
    """table[ids] (int ids [N] in [0, V)) -> [N, W]."""
    return table[ids.long()]


def dma_gather_rows(table, ids, block_rows=16):
    """K5: table[ids] -> new [N, W] float32 tensor, one bulk copy per row,
    `block_rows` (B) rows a block. Requires N % B == 0 and W % 4 == 0, as
    the TPU benchmark did; an id outside [0, V) gives a zero row on the
    card (the plain version raises)."""
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
    lib = kb.library()
    out = torch.empty((n, w), dtype=torch.float32, device=table.device)
    kb.check(lib.ge_dma_gather_rows(
        table.device.index, table.data_ptr(), table.shape[0], ids.data_ptr(),
        n, w, block_rows, out.data_ptr(), kb.stream_ptr(table.device)),
        "dma_gather_rows")
    dma_gather_rows.launches += 1
    return out


dma_gather_rows.launches = 0
