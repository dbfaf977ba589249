"""Fused quantized all-pairs squared L2 (port of
``hnsw_rs_tpu/ops/pallas/l2_kernel.py``).

:func:`pairwise_l2sq_kernel` is the counterpart of the JAX package's
``pairwise_l2sq_pallas``: squared L2 [B, N] from float32 queries to
uint8 per-vector-quantized points by the affine identity

    |q - (delta*c + min)|^2 = |q|^2 + |x|^2 - 2*(delta*(q.c) + min*sum(q)),

clamped at 0. On a CUDA tensor it launches the hand-written kernel in
``csrc/l2_kernel.cu`` (the query's limbs split on the card, then exact
int8 tensor-core products of limbs and codes; built and loaded by
:mod:`.cuda_build`); on a CPU tensor it runs :func:`pairwise_l2sq_plain`. The Pallas kernel's ``tb``,
``tn`` and ``interpret`` arguments were Mosaic tiling and interpret-mode
knobs and have no counterpart; the CUDA kernel masks its own ragged
edges and writes exactly [B, N].

As in the JAX package, nothing else in the index calls this kernel: it is
a public entry point of its own.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .limbs import aligned_codes, query_operands, query_workspace

_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def pairwise_l2sq_kernel(
    q: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
    normsq: torch.Tensor, fast: bool = False,
) -> torch.Tensor:
    """Squared L2 f32[B, N] from queries ``q`` f32[B, d] to quantized
    points (``codes`` u8[N, d], ``scales`` f32[N, 2] as (min, delta),
    ``normsq`` f32[N] = |x|^2, see ``ops.distance.point_normsq``).
    ``fast=True`` rounds q to bf16 for the product (the sums stay f32).

    A CUDA tensor launches the kernel (counted in
    ``pairwise_l2sq_kernel.launches``); a CPU tensor takes the plain
    version. Pass live rows only: the store's poisoned capacity rows have
    an |x|^2 that overflows float32 for d above ~340."""
    cuda_build.check_inputs(q, codes, scales, normsq)
    if q.device.type == "cpu":
        return pairwise_l2sq_plain(q, codes, scales, normsq, fast)
    b = q.shape[0]
    n = codes.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=q.device)
    if b == 0 or n == 0:
        return out
    limbs, sums = query_workspace(b, q.shape[1], q.device)
    codes_g, scales_g, normsq_g, d_g = aligned_codes(codes, scales, normsq)
    sp = sums.data_ptr()  # qscale, qsq, qsum: B floats each
    cuda_build.launch(
        "l2_kernel", "pairwise_l2sq_launch", _ARGTYPES, q.device,
        q.data_ptr(), limbs.data_ptr(), sp, sp + 4 * b, sp + 8 * b, codes_g.data_ptr(), scales_g.data_ptr(),
        normsq_g.data_ptr(), out.data_ptr(), b, n, q.shape[1], limbs.shape[2],
        d_g, int(fast),
    )
    query_operands.launches += 1  # the limb split runs inside that call
    pairwise_l2sq_kernel.launches += 1
    return out


pairwise_l2sq_kernel.launches = 0


def pairwise_l2sq_plain(
    q: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
    normsq: torch.Tensor, fast: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`pairwise_l2sq_kernel`: the affine
    form of ``ops.distance.pairwise_l2sq_mxu`` (one float32 product),
    with q rounded to bf16 for the product when ``fast``."""
    qp = q.to(torch.bfloat16).to(torch.float32) if fast else q
    qdotc = qp @ codes.to(torch.float32).T
    qdotx = scales[:, 1][None, :] * qdotc + scales[:, 0][None, :] * q.sum(
        dim=-1, keepdim=True)
    qsq = (q * q).sum(dim=-1, keepdim=True)
    return torch.clamp_min(qsq + normsq[None, :] - 2.0 * qdotx, 0.0)
