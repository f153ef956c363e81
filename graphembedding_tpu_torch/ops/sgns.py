"""SGNS block gradients (K1): CUDA kernel and plain version.

Replaces `graphembedding_tpu/ops/pallas_sgns.py::_kernel` (entry
`sgns_block_grads_pallas`); the plain version computes
`sgns_block_grads_xla`'s function with einsums. Shapes: yin, yout
[G, PL, D]; vn [G2, K, D]; mask [G, PL, PL]; neg_ok [G2, r*PL, K] with
r = G // G2 packing groups sharing one negative set. Returns
(d_yin [G, PL, D], d_yout [G, PL, D], d_vn [G2, K, D], loss [G]).

The per-group loss carries that group's own share of the negative loss,
as the Pallas kernel's does; the XLA oracle spreads a sharing group's
negative loss evenly over its r groups, so with r > 1 the two agree in
their sums over each sharing group.

On the H100 the kernel runs the six products on the tensor cores in
split TF32 (three TF32 passes, FP32-level accuracy), one block per
packing group, with the r groups of a sharing group in one thread-block
cluster that sums d_vn in rank order (no atomics: the same bits from run
to run), and its inputs arriving by bulk copies (see `csrc/sgns.cu`). The
wrapper takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the kernel or raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from graphembedding_tpu_torch.kernels import build as kb

_SMEM_LIMIT = 232448  # bytes of shared memory a Hopper block may opt into
_MAX_CLUSTER = 8  # portable thread-block cluster size: r groups a cluster


def sgns_block_grads_plain(yin, yout, vn, mask, neg_ok, neg_w):
    G, PL, D = yin.shape
    G2 = vn.shape[0]
    r = G // G2
    logits = torch.einsum("gld,gmd->glm", yin, yout)
    g_pos = (torch.sigmoid(logits) - 1.0) * mask
    yin_n = yin.reshape(G2, r * PL, D)
    nlog = torch.einsum("gld,gkd->glk", yin_n, vn)
    np_w = (mask.sum(2).reshape(G2, r * PL) * neg_w)[:, :, None]
    g_neg = torch.sigmoid(nlog) * np_w * neg_ok
    d_yin = torch.einsum("glm,gmd->gld", g_pos, yout) + torch.einsum(
        "glk,gkd->gld", g_neg, vn).reshape(G, PL, D)
    d_yout = torch.einsum("glm,gld->gmd", g_pos, yin)
    d_vn = torch.einsum("glk,gld->gkd", g_neg, yin_n)
    pos = torch.where(mask > 0, F.logsigmoid(logits), 0.0) * mask
    neg = (F.logsigmoid(-nlog) * np_w * neg_ok).reshape(G, PL * vn.shape[1])
    loss = -(pos.sum((1, 2)) + neg.sum(1))
    return d_yin, d_yout, d_vn, loss


def _smem_bytes(PL, D, K):
    """Dynamic shared memory of one block: mirrors `Plan` in csrc/sgns.cu,
    which refuses a launch whose size disagrees. PL, K and D are padded to
    multiples of 32; rows are spaced 4 floats wider."""
    r32 = lambda n: -(-n // 32) * 32  # noqa: E731
    PLp, Kp, Dp = r32(PL), r32(K), r32(D)
    ldy, ldg = Dp + 4, max(PLp, Kp) + 4
    tiles = (PLp * ldy                       # yin
             + max(PLp * ldy,                # yout, then vn and neg_ok
                   Kp * ldy + -(-PL * K // 4) * 4)
             + PLp * ldg)                    # mask, g_pos, g_neg
    # n_pairs parts, n_pairs, loss parts, live steps of the g_pos products
    small = PLp // 32 * PLp + PLp + 16 + 2 * (PLp // 32)
    return 32 + 4 * (tiles + small)          # 32: the three mbarriers


def _row_stride(t, rows, name):
    """Stride between consecutive rows of a [B, rows, D] tensor whose
    rows may be spaced wider than D (a column slice), or raise."""
    ld = t.stride(1)
    if t.stride(2) != 1 or t.stride(0) != rows * ld or ld % 4:
        raise ValueError(f"sgns_block_grads: {name} must have contiguous "
                         f"rows spaced by a multiple of 4 floats, got "
                         f"strides {t.stride()}")
    if t.data_ptr() % 16:
        raise ValueError(f"sgns_block_grads: {name} must be 16-byte "
                         "aligned")
    return ld


def sgns_block_grads(yin, yout, vn, mask, neg_ok, neg_w):
    """K1: gradient blocks of packed SGNS groups (see module doc)."""
    if yin.dim() != 3 or vn.dim() != 3:
        raise ValueError("sgns_block_grads: yin and vn must be 3-D")
    G, PL, D = yin.shape
    G2, K, _ = vn.shape
    if G2 == 0 or G % G2:
        raise ValueError(f"G ({G}) must be a multiple of G2 ({G2})")
    r = G // G2
    want = {"yout": (G, PL, D), "vn": (G2, K, D), "mask": (G, PL, PL),
            "neg_ok": (G2, r * PL, K)}
    for name, t in (("yin", yin), ("yout", yout), ("vn", vn),
                    ("mask", mask), ("neg_ok", neg_ok)):
        if t.dtype != torch.float32 or t.device != yin.device:
            raise ValueError(f"sgns_block_grads: {name} must be float32 on "
                             f"{yin.device}, got {t.dtype} on {t.device}")
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"sgns_block_grads: {name} shape "
                             f"{tuple(t.shape)}, want {want[name]}")
    dev = yin.device.type
    if dev == "cpu":
        return sgns_block_grads_plain(yin, yout, vn, mask, neg_ok, neg_w)
    if dev != "cuda":
        raise ValueError(f"sgns_block_grads: unsupported device {yin.device}")
    if D % 4:
        raise ValueError(f"sgns_block_grads: D ({D}) must be a multiple of 4")
    if r > _MAX_CLUSTER:
        raise ValueError(f"sgns_block_grads: {r} groups share a negative set;"
                         f" the kernel takes at most {_MAX_CLUSTER}")
    smem = _smem_bytes(PL, D, K)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"sgns_block_grads: PL={PL}, D={D}, K={K} need "
                         f"{smem} bytes of shared memory (> {_SMEM_LIMIT})")
    ld_in = _row_stride(yin, PL, "yin")
    ld_out = _row_stride(yout, PL, "yout")
    ld_vn = _row_stride(vn, K, "vn")
    if not (mask.is_contiguous() and neg_ok.is_contiguous()):
        raise ValueError("sgns_block_grads: mask and neg_ok must be "
                         "contiguous")
    opts = dict(dtype=torch.float32, device=yin.device)
    d_yin = torch.empty((G, PL, D), **opts)
    d_yout = torch.empty((G, PL, D), **opts)
    d_vn = torch.empty((G2, K, D), **opts)
    loss = torch.empty((G,), **opts)
    lib = kb.library()
    kb.check(lib.ge_sgns_block_grads(
        yin.device.index, yin.data_ptr(), ld_in, yout.data_ptr(), ld_out,
        vn.data_ptr(), ld_vn, mask.data_ptr(), neg_ok.data_ptr(),
        d_yin.data_ptr(), d_yout.data_ptr(), d_vn.data_ptr(),
        loss.data_ptr(), G, G2, PL, D, K, float(neg_w), smem,
        kb.stream_ptr(yin.device)), "sgns_block_grads")
    sgns_block_grads.launches += 1
    return d_yin, d_yout, d_vn, loss


sgns_block_grads.launches = 0
