"""The collectives of the mesh: all-gather, all-to-all (even or ragged) and
a sum.

Three operations of `torch.distributed`, and no other, carry every
exchange: `all_gather_into_tensor` (named `all_gather_single` where torch
has that name), `all_to_all_single` (with split sizes for the ragged form)
and `all_reduce` with SUM. Gloo (torch 2.13) takes all three for CPU
tensors, uneven and empty splits included.

Host staging is a rule by backend, never a retry: when a group's backend
is gloo, a CUDA tensor is copied to the host, exchanged there and copied
back, every time (gloo's all-to-all has no CUDA path). NCCL gets the
tensors as they are. So two gloo ranks on one card exercise the same
exchanges as NCCL ranks on cards of their own, with the kernels on the
card, at the cost of the copies. `host_staged` states the rule, so that a
chunk of steps knows before it starts whether a CUDA graph can capture its
exchanges (a capture refuses the copies to the host).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def host_staged(group, device) -> bool:
    """Whether an exchange on `group` of a tensor on `device` goes through
    host memory: gloo with a tensor off the CPU. NCCL, and gloo on CPU
    tensors, exchange the tensors where they lie."""
    return dist.get_backend(group) == "gloo" and \
        torch.device(device).type != "cpu"


def _staged(x, group):
    """x as the group's backend takes it: on the host for gloo."""
    return x.cpu() if host_staged(group, x.device) else x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n, *x.shape]: block i is rank i's x (ranks of `group` in order);
    x has at least one dimension."""
    src = _staged(x.contiguous(), group)
    n = dist.get_world_size(group)
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=src.device)
    _all_gather_single(out, src, group=group)
    return out.view(n, *x.shape).to(x.device)


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x [n, ...]: block j goes to rank j; returns [n, ...] whose block i
    came from rank i."""
    src = _staged(x.contiguous(), group)
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the ranks of `group` (a new tensor)."""
    src = _staged(x.contiguous(), group)
    out = src.clone() if src is x else src
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out.to(x.device)


def ragged_all_to_all(frame: torch.Tensor, counts: torch.Tensor, group,
                      extra: torch.Tensor = None):
    """Send the first counts[j] rows of frame[j] to rank j.

    frame [n, cap, ...]: block j holds the rows bound for rank j, the
    counts[j] occupied ones first; counts [n] ints. The counts go out first
    in one even all-to-all of [n, 1 + k] int64, with `extra` [n, k] ints
    (row j to rank j) riding along; the host reads them, the one host sync,
    and `all_to_all_single` with those split sizes sends the occupied rows
    only. Returns (rows [sum of received counts, ...] grouped by source
    rank, received counts (a list), received extra (a list of n lists of
    k ints; [] a rank without `extra`)).
    """
    n = frame.shape[0]
    head = counts.reshape(n, 1).to(torch.int64)
    if extra is not None:
        head = torch.cat([head, extra.reshape(n, -1).to(torch.int64)], 1)
    sent, got = torch.stack([head, all_to_all(head, group)]).tolist()
    send_sizes = [row[0] for row in sent]
    recv_sizes = [row[0] for row in got]
    src = _staged(torch.cat([frame[j, :c] for j, c in enumerate(send_sizes)]),
                  group)
    out = src.new_empty((sum(recv_sizes), *frame.shape[2:]))
    dist.all_to_all_single(out, src, output_split_sizes=recv_sizes,
                           input_split_sizes=send_sizes, group=group)
    return out.to(frame.device), recv_sizes, [row[1:] for row in got]
