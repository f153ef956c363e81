"""Hierarchical-softmax block gradients (K10): CUDA kernel and plain version.

K10 replaces no TPU kernel: the JAX package scores the hs=1 step with XLA
einsums (`graphembedding_tpu/train/hsoftmax.py`, the step of
`hs_block_chunk`). The plain version is that scoring as the port's step
wrote it: three batched float32 products over the flattened n = m * T + t
axis of a dense [G, PL, PL * T] grid, most of whose entries the window's
mask zeroes. K10 scores the window's pairs only (`csrc/hs.cu`).

Shapes: w_in [V, D], w_tree [n_inner, D], tok and eff [G, PL] int32
(token ids, -1 pads; window draws), points [V, T] int32 (Huffman paths,
-1 padded) and codes [V, T] float32, window_ok [PL, PL] bool and dm
[PL, PL] int64 (`train.skipgram.window_geometry`). A pair (center l,
context m) of a group counts where window_ok[l, m], dm[l, m] <= eff[l]
and both tokens are real; each level of m's path scores it. Returns
(d_yin [G * PL, D], d_tree [G * PL * T, D], loss), zero rows where no
pair reaches, loss the 0-d sum of -log_sigmoid over the scored (pair,
level) entries.

The kernel reads the walks' bounds from dm (a walk starts where
dm[0, p] == 0) and takes window_ok to pair positions of one walk only, as
window_geometry builds them. It computes in full float32 on FFMA and sums
in a fixed order inside one block, so its results are the same bits from
run to run; against the plain version they differ by the order of the
sums. The wrapper takes the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graphembedding_tpu_torch.kernels import build as kb
from graphembedding_tpu_torch.ops.rows import gather_rows_plain

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may opt into
_Q = 8    # positions of a group whose walks one block owns (kQ)
_CT = 16  # centers of one context scored at a time (kCT)
_WARPS = 8


def hs_block_grads_plain(w_in, w_tree, tok, eff, points, codes, window_ok,
                         dm, gather=gather_rows_plain, reduce=None):
    """K10's function by dense batched products. `gather` fetches table
    rows (the step passes K3 on the card); `reduce`, when given, completes
    partial logits (over a column slice of the tables) before the sigmoid:
    the mesh's tensor-parallel step sums them over its model axis."""
    G, PL = tok.shape
    D = w_in.shape[1]
    T = points.shape[1]
    N = PL * T
    tok_ok = tok >= 0
    tok_safe = torch.where(tok_ok, tok, 0)
    yin = gather(w_in, tok_safe.reshape(-1)).view(G, PL, D)  # centers
    pts = points[tok_safe]  # [G, PL, T] context paths
    label = 1.0 - codes[tok_safe]  # [G, PL, T]
    pts_ok = (pts >= 0) & tok_ok[:, :, None]
    pts_safe = torch.where(pts_ok, pts, 0)
    ptv = gather(w_tree, pts_safe.reshape(-1)).view(G, N, D)

    mask = (window_ok[None] & (dm[None] <= eff[:, :, None])
            & tok_ok[:, :, None] & tok_ok[:, None, :]).to(torch.float32)
    # logits of every (center l, context m, level t) over n = m * T + t
    logits = torch.bmm(yin, ptv.transpose(1, 2))  # [G, PL, N]
    if reduce is not None:
        logits = reduce(logits)
    gate_n = (mask[:, :, :, None] * pts_ok[:, None, :, :]).reshape(G, PL, N)
    gmat = (label.reshape(G, 1, N) - torch.sigmoid(logits)) * gate_n
    d_yin = torch.bmm(gmat, ptv)  # [G, PL, D]
    d_tree = torch.bmm(gmat.transpose(1, 2), yin)  # [G, N, D]
    sgn = 2.0 * label.reshape(G, 1, N) - 1.0
    ll = F.logsigmoid(sgn * logits)
    return d_yin.reshape(-1, D), d_tree.reshape(-1, D), -(ll * gate_n).sum()


def _smem_bytes(PL, D, T):
    """Dynamic shared memory of one block: mirrors `Plan` in csrc/hs.cu,
    which refuses a launch whose size disagrees. Two buffers each of T
    tree rows and of _CT center rows, rows spaced D rounded up to 4, plus
    4; g of _CT x T; three slots of a context's labels (T) and centers
    (PL); counts, walk bounds, warp sums."""
    Dp = -(-D // 4) * 4 + 4
    return 4 * (2 * (T + _CT) * Dp + _CT * T + 3 * T + 3 * PL + 7 + 2 * _Q
                + _WARPS)


_INPUTS = (("tok", torch.int32, 2), ("eff", torch.int32, 2),
           ("points", torch.int32, 2), ("codes", torch.float32, 2),
           ("window_ok", torch.bool, 2), ("dm", torch.int64, 2))


def hs_block_grads(w_in, w_tree, tok, eff, points, codes, window_ok, dm):
    """K10: the hs=1 step's gradients over the window's pairs (see module
    doc)."""
    if w_in.dim() != 2 or w_tree.dim() != 2 or w_in.shape[1] != \
            w_tree.shape[1]:
        raise ValueError(f"hs_block_grads: w_in {tuple(w_in.shape)} and "
                         f"w_tree {tuple(w_tree.shape)} must be [*, D]")
    G, PL = tok.shape
    D, T = w_in.shape[1], points.shape[1]
    want = {"eff": (G, PL), "codes": tuple(points.shape),
            "window_ok": (PL, PL), "dm": (PL, PL)}
    for name, t in (("w_in", w_in), ("w_tree", w_tree)):
        if t.dtype != torch.float32 or t.device != tok.device:
            raise ValueError(f"hs_block_grads: {name} must be float32 on "
                             f"{tok.device}, got {t.dtype} on {t.device}")
    args = dict(tok=tok, eff=eff, points=points, codes=codes,
                window_ok=window_ok, dm=dm)
    for name, dtype, dim in _INPUTS:
        t = args[name]
        if t.dtype != dtype or t.dim() != dim or t.device != tok.device:
            raise ValueError(f"hs_block_grads: {name} must be {dtype} "
                             f"{dim}-D on {tok.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"hs_block_grads: {name} shape "
                             f"{tuple(t.shape)}, want {want[name]}")
    dev = tok.device.type
    if dev == "cpu":
        return hs_block_grads_plain(w_in, w_tree, tok, eff, points, codes,
                                    window_ok, dm)
    if dev != "cuda":
        raise ValueError(f"hs_block_grads: unsupported device {tok.device}")
    if w_in.stride(1) != 1 or w_tree.stride(1) != 1:
        raise ValueError("hs_block_grads: table rows must be contiguous")
    if not all(t.is_contiguous() for t in args.values()):
        raise ValueError("hs_block_grads: tok, eff, points, codes, "
                         "window_ok and dm must be contiguous")
    smem = _smem_bytes(PL, D, T)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"hs_block_grads: PL={PL}, D={D}, T={T} need "
                         f"{smem} bytes of shared memory (> {_SMEM_LIMIT})")
    # 16-byte vectors where every row starts on 16 bytes
    vec = (D % 4 == 0 and w_in.stride(0) % 4 == 0
           and w_tree.stride(0) % 4 == 0 and w_in.data_ptr() % 16 == 0
           and w_tree.data_ptr() % 16 == 0)
    opts = dict(dtype=torch.float32, device=tok.device)
    d_yin = torch.empty((G * PL, D), **opts)
    d_tree = torch.empty((G * PL * T, D), **opts)
    parts = torch.empty((G, PL), **opts)
    lib = kb.library()
    kb.check(lib.ge_hs_block_grads(
        tok.device.index, w_in.data_ptr(), w_in.stride(0), w_tree.data_ptr(),
        w_tree.stride(0), tok.data_ptr(), eff.data_ptr(), points.data_ptr(),
        codes.data_ptr(), window_ok.data_ptr(), dm.data_ptr(),
        d_yin.data_ptr(), d_tree.data_ptr(), parts.data_ptr(), G, PL, D, T,
        int(vec), smem, kb.stream_ptr(tok.device)), "hs_block_grads")
    hs_block_grads.launches += 1
    return d_yin, d_tree, parts.sum()


hs_block_grads.launches = 0
