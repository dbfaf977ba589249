"""Query limbs: the exact integer form in which the tensor-core distance
kernels (``csrc/dist_core.cuh``) take a float32 query.

A query row q_b is written as a fixed-point integer Q_b = round(q_b / s_b)
with a power-of-two scale s_b, and Q_b is split into ``n_limbs`` balanced
base-256 digits (each in [-128, 127]):

    Q_b = sum_l 256^l * limb[l, b],    q_b ~= s_b * Q_b.

The scale is s_b = 2^(ceil(log2 max|q_b|) - (8L - 2)), so |Q_b| <= 2^(8L-2):
one bit of headroom below 2^(8L-1) keeps the top limb inside int8 even
when max|q_b| is an exact power of two. Each component is represented to
within s_b / 2, about 2^-31 of max|q_b| at L = 4.

Against u8 codes c, every limb product S_l = sum_k c_k * limb[l, b, k] is
an exact int32 on the tensor cores (|S_l| <= 255 * 128 * d < 2^31). The
kernels (``csrc/dist_core.cuh``) fold the S_l into one float32 from the
top limb down,

    acc = S_{L-1};  acc = acc * 256 + S_l  (one rounding each);
    q.c = acc * s_b  (exact: a power of two).
"""

from __future__ import annotations

import torch

N_LIMBS = 4  # limbs per query that the kernels take (dist::kLimbs)
K_STEP = 32  # the int8 tensor-core product's depth: d is padded to a multiple
CHUNK = 256  # the widest d_pad whose limbs stay resident (dist::kChunkDim)


def padded_dim(d: int) -> int:
    """The d_pad the kernels take for ``d``: ``d`` rounded up to a whole
    number of tensor-core steps and, past ``CHUNK``, to one that splits
    into ceil(d_pad / CHUNK) equal chunks of whole steps (the streamed
    layout of ``csrc/dist_core.cuh``)."""
    d32 = -(-d // K_STEP) * K_STEP
    if d32 <= CHUNK:
        return d32
    n = -(-d32 // CHUNK)
    return n * (-(-d32 // (n * K_STEP)) * K_STEP)


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as float32, exactly, for integer k in [-126, 127]."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def query_limbs(q: torch.Tensor, n_limbs: int = N_LIMBS) -> tuple[torch.Tensor, torch.Tensor]:
    """(limbs int8[L, B, d_pad], scale float32[B]) of float32 queries
    ``q`` [B, d], with ``sum_l 256^l limbs[l] * scale[:, None]`` within
    ``scale / 2`` of ``q`` in every component and zero in the padded
    columns. All-zero rows get all-zero limbs."""
    if q.dim() != 2 or q.dtype != torch.float32:
        raise ValueError("q must be float32 [B, d]")
    if not 1 <= n_limbs <= 4:
        raise ValueError(f"n_limbs must be in 1..4, got {n_limbs}")
    b, d = q.shape
    q = torch.nn.functional.pad(q, (0, padded_dim(d) - d))
    mant, ex = torch.frexp(q.abs().amax(dim=1) if d else q.new_zeros(b))
    # ceil(log2 m): frexp gives m = mant * 2^ex with mant in [0.5, 1), and
    # m is 2^(ex-1) exactly when mant == 0.5. The floor at -96 keeps both
    # 2^shift and 2^-shift normal floats (it only matters below 2^-96).
    e = torch.clamp_min(ex - (mant == 0.5).to(ex.dtype), -96)
    shift = e - (8 * n_limbs - 2)
    scale = _pow2(shift)
    big = torch.round(q / scale[:, None]).to(torch.int64)  # exact; |.| <= 2^(8L-2)
    # balanced digits in one pass: adding 128 * (1 + 256 + ...) makes every
    # base-256 digit of big + bias equal to its balanced digit + 128, and
    # flipping that byte's top bit reads it back as the int8 digit
    bias = sum(128 << (8 * l) for l in range(n_limbs))
    shifts = torch.arange(0, 8 * n_limbs, 8, device=q.device)[:, None, None]
    limbs = ((big + bias)[None] >> shifts).to(torch.uint8) ^ 128
    return limbs.view(torch.int8), scale


def tensor_core_operands(q, codes, scales, normsq, fast: bool = False):
    """What the tensor-core kernels take: (limbs s8[L, B, d_pad],
    qscale f32[B], qsq f32[B], qsum f32[B], codes u8[N, d_g], scales,
    normsq, d_pad, d_g). |q|^2 and sum(q) come from the unrounded q; with
    ``fast`` the limbs are those of q rounded to bf16. TMA needs 16-byte
    row strides and base addresses, so codes whose d is not a multiple of
    16 are copied to rows of ``d_g`` = d rounded up to 16 bytes (zero
    padded), and a misaligned tensor is copied."""
    qp = q.to(torch.bfloat16).to(torch.float32) if fast else q
    limbs, qscale = query_limbs(qp)
    d = codes.shape[1]
    d_g = -(-d // 16) * 16
    if d_g != d or codes.data_ptr() % 16:
        codes = torch.nn.functional.pad(codes, (0, d_g - d))
    scales, normsq = (t if t.data_ptr() % 16 == 0 else t.clone()
                      for t in (scales, normsq))
    return (limbs, qscale, (q * q).sum(dim=-1), q.sum(dim=-1), codes, scales,
            normsq, limbs.shape[2], d_g)
