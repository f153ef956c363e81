"""Row gather (K3) and row scatter-add (K2): CUDA kernels and plain versions.

K3 `gather_rows` replaces the contract of
`graphembedding_tpu/ops/pallas_scatter.py::_gather_mm_kernel` (entry
`gather_rows_matmul`): `table[ids]`. K2 `scatter_add_rows` replaces the
contract of `_rmw_kernel` (entry `scatter_add_rows`): `table.at[ids].add
(grads)` with ids outside [0, V) dropped, as XLA's scatter drops them.

On the H100 both are bound by device-memory traffic. The gather reads
each row with 16-byte loads, one warp per row. The scatter-add follows the
TPU kernel's design: a stable sort of the ids (PyTorch's, as the TPU
kernel used XLA's), then one read-modify-write per unique row, each row's
gradients added in their original order. That is the order of the plain
version's sequential loop on the CPU, so the two agree bit for bit and the
kernel is deterministic; its time is bound by the longest run of one id
(see `csrc/rows.cu`). A wrapper takes its plain version only for tensors
on the CPU; for CUDA tensors it launches its kernel or raises.
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


def scatter_add_rows(table, ids, grads):
    """K2: table[ids] += grads in place (ids outside [0, V) dropped),
    each row summed in the order of ids; returns table."""
    on_cuda = _check_rows(table, ids, "scatter_add_rows")
    n = ids.shape[0]
    if (grads.dtype != torch.float32 or grads.device != table.device
            or tuple(grads.shape) != (n, table.shape[1])):
        raise ValueError(
            f"scatter_add_rows: grads must be float32 {(n, table.shape[1])} "
            f"on {table.device}, got {grads.dtype} {tuple(grads.shape)} on "
            f"{grads.device}")
    if not on_cuda:
        return scatter_add_rows_plain(table, ids, grads)
    if not grads.is_contiguous():
        raise ValueError("scatter_add_rows: grads must be contiguous")
    lib = kb.library()
    sorted_ids, order = torch.sort(ids, stable=True)
    kb.check(lib.ge_scatter_add_rows(
        table.device.index, table.data_ptr(), table.stride(0),
        table.shape[0], sorted_ids.data_ptr(), order.data_ptr(),
        grads.data_ptr(), n, table.shape[1], kb.stream_ptr(table.device)),
        "scatter_add_rows")
    scatter_add_rows.launches += 1
    return table


scatter_add_rows.launches = 0
