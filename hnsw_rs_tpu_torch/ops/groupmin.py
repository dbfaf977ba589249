"""Fused distance + group-min exact flat top-k (port of
``hnsw_rs_tpu/ops/pallas/l2_groupmin.py``).

Exact top-k in two passes, as in the JAX package:

1. :func:`group_min_d2` — per-128-row-group (d2, row) minima [B, N/128].
   On a CUDA tensor it launches the hand-written kernel in
   ``csrc/group_min.cu`` (the query's limbs split on the card, then exact
   int8 tensor-core products of limbs and codes: two kernels a call); on a CPU tensor it runs
   :func:`group_min_d2_plain`.
2. :func:`rescore_groups` — the top ``k + _MARGIN`` groups by (min d2,
   group) provably hold every true top-k element (a group holding one has
   a minimum <= the k-th distance, and distinct groups have distinct
   minima); their rows are gathered, rescored with the affine form and
   sorted by (d2, id). The margin absorbs ulp-level disagreement between
   the kernel's sums and the rescoring product at the k-th boundary.

The kernel is built and loaded by :mod:`.cuda_build`.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import cuda_build
from .distance import pairwise_l2sq_mxu
from .limbs import aligned_codes, query_operands, query_workspace
from .topk import INF, PAD_ID, sort_dist_id

GROUP = 128
_MARGIN = 8  # extra groups rescored in pass 2 (ulp safety at the boundary)

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def build() -> Path:
    """Compile ``csrc/group_min.cu`` unless its library exists; returns
    the library path (the compiler's report sits beside it, ``.log``)."""
    return cuda_build.build("group_min")[0]


def _check(q, codes, scales, normsq) -> None:
    cuda_build.check_inputs(q, codes, scales, normsq)
    if codes.shape[0] % GROUP:
        raise ValueError(f"N={codes.shape[0]} is not a multiple of {GROUP}")


def group_min_d2(
    q: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
    normsq: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-128-row-group lexicographic (d2, row) minima:
    (gmin_d2 f32[B, N/128], gmin_row i32[B, N/128]), rows as global ids.

    ``codes`` must be padded to a multiple of 128 rows, pad rows carrying
    ``normsq = +inf``. A CUDA tensor launches the kernel (counted in
    ``group_min_d2.launches``); a CPU tensor takes the plain version."""
    _check(q, codes, scales, normsq)
    if q.device.type == "cpu":
        return group_min_d2_plain(q, codes, scales, normsq)
    b = q.shape[0]
    n = codes.shape[0]
    out_d = torch.empty((b, n // GROUP), dtype=torch.float32, device=q.device)
    out_i = torch.empty((b, n // GROUP), dtype=torch.int32, device=q.device)
    if b == 0 or n == 0:
        return out_d, out_i
    limbs, sums = query_workspace(b, q.shape[1], q.device)
    codes_g, scales_g, normsq_g, d_g = aligned_codes(codes, scales, normsq)
    sp = sums.data_ptr()  # qscale, qsq, qsum: B floats each
    cuda_build.launch(
        "group_min", "group_min_d2_launch", _ARGTYPES, q.device,
        q.data_ptr(), limbs.data_ptr(), sp, sp + 4 * b, sp + 8 * b, codes_g.data_ptr(), scales_g.data_ptr(),
        normsq_g.data_ptr(), out_d.data_ptr(), out_i.data_ptr(), b, n,
        q.shape[1], limbs.shape[2], d_g,
    )
    query_operands.launches += 1  # the limb split runs inside that call
    group_min_d2.launches += 1
    return out_d, out_i


group_min_d2.launches = 0


def group_min_d2_plain(
    q: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
    normsq: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`group_min_d2`: chunked
    :func:`pairwise_l2sq_mxu`, viewed as [B, N/128, 128], lexicographic
    minimum per group."""
    b = q.shape[0]
    n = codes.shape[0]
    # bound the [B, chunk] distance temp at 2^26 floats
    chunk = max(GROUP, (1 << 26) // max(b, 1) // GROUP * GROUP)
    iota = torch.arange(GROUP, dtype=torch.int32, device=q.device)
    ds, rs = [], []
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        d2 = pairwise_l2sq_mxu(q, codes[lo:hi], scales[lo:hi], normsq[lo:hi])
        d3 = d2.view(b, (hi - lo) // GROUP, GROUP)
        gmin = d3.amin(dim=-1)
        amin = torch.where(d3 == gmin[..., None], iota, GROUP).amin(dim=-1)
        base = torch.arange(lo, hi, GROUP, dtype=torch.int32, device=q.device)
        ds.append(gmin)
        rs.append(base[None, :] + amin)
    return torch.cat(ds, dim=1), torch.cat(rs, dim=1)


def rescore_groups(
    q: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
    normsq: torch.Tensor, gd: torch.Tensor, gi: torch.Tensor, k: int,
    n_valid: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pass 2 of :func:`flat_topk_fused`: exact (d2 [B, k], ids [B, k])
    from the group minima (``gd``, ``gi`` [B, N/128]) of padded
    ``codes``; rows at or past ``n_valid`` are padding."""
    b, d = q.shape
    g = gd.shape[1]
    l = min(k + _MARGIN, g)
    ng = torch.sort(gd, dim=1, stable=True).indices[:, :l]
    grp = gi.gather(1, ng).long() // GROUP  # [B, L] group index
    cb = codes.view(g, GROUP * d)
    sb = scales.view(g, GROUP * 2)
    nb = normsq.view(g, GROUP)
    iota = torch.arange(GROUP, device=q.device)
    # bound the gathered [h, L*128, d] f32 rows at ~512 MB per query chunk
    h = max(1, (1 << 29) // (l * GROUP * d * 4))
    outs_d, outs_i = [], []
    for lo in range(0, b, h):
        gc = grp[lo:lo + h]
        r = gc.shape[0]
        crow = cb[gc].view(r, l * GROUP, d).to(torch.float32)
        srow = sb[gc].view(r, l * GROUP, 2)
        nrow = nb[gc].view(r, l * GROUP)
        ids = (gc[:, :, None] * GROUP + iota).view(r, l * GROUP)
        qc = q[lo:lo + h]
        qdotc = torch.bmm(crow, qc[:, :, None])[..., 0]
        qsum = qc.sum(dim=1, keepdim=True)
        qsq = (qc * qc).sum(dim=1, keepdim=True)
        d2 = torch.clamp_min(
            qsq + nrow - 2.0 * (srow[..., 1] * qdotc + srow[..., 0] * qsum), 0.0
        )
        valid = ids < n_valid
        d2 = torch.where(valid, d2, INF)
        ids = torch.where(valid, ids, PAD_ID).to(torch.int32)
        sd, si = sort_dist_id(d2, ids)
        outs_d.append(sd[:, :k])
        outs_i.append(si[:, :k])
    return torch.cat(outs_d), torch.cat(outs_i)


def pad_to_groups(codes, scales, normsq):
    """Pad the collection to a multiple of 128 rows (zero codes and
    scales, ``normsq = +inf`` so pad rows never win)."""
    n0 = codes.shape[0]
    pad = -n0 % GROUP
    if pad == 0:
        return codes, scales, normsq
    dev = codes.device
    return (
        torch.cat([codes, codes.new_zeros((pad, codes.shape[1]))]),
        torch.cat([scales, scales.new_zeros((pad, 2))]),
        torch.cat([normsq, torch.full((pad,), INF, device=dev)]),
    )


def flat_topk_fused(
    q: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
    normsq: torch.Tensor, k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k flat search: (d2 [B, k], ids [B, k]) ordered by
    (d2, id), through :func:`group_min_d2`. Any B and N."""
    n0 = codes.shape[0]
    codes, scales, normsq = pad_to_groups(codes, scales, normsq)
    q = q.contiguous()
    gd, gi = group_min_d2(q, codes, scales, normsq)
    return rescore_groups(q, codes, scales, normsq, gd, gi, k, n0)
