"""Batched squared-L2 distances over quantized vectors (port of
``hnsw_rs_tpu/ops/distance.py``).

Distances are compared as squared L2 throughout; ``sqrt`` is applied only
at API boundaries. Matrix products stay in true float32: TF32 keeps ~10
mantissa bits, and a ~0.1% product error flips near-tie orderings (the
reason the JAX package pins ``Precision.HIGHEST``). PyTorch's matmul
default is float32 (``torch.backends.cuda.matmul.allow_tf32 = False``);
callers must not turn TF32 on.
"""

from __future__ import annotations

import torch

from .quant import dequantize


def l2sq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise-broadcast squared L2 over the last axis, float32."""
    d = a.to(torch.float32) - b.to(torch.float32)
    return (d * d).sum(dim=-1)


def pairwise_l2sq_exact(
    q: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor
) -> torch.Tensor:
    """All-pairs squared L2, direct form: [B, d] x [N, d] -> [B, N].
    Materializes [B, N, d]; keep B and N small."""
    x = dequantize(codes, scales)
    diff = q[:, None, :] - x[None, :, :]
    return (diff * diff).sum(dim=-1)


def pairwise_l2sq_mxu(
    q: torch.Tensor,
    codes: torch.Tensor,
    scales: torch.Tensor,
    normsq: torch.Tensor | None = None,
) -> torch.Tensor:
    """All-pairs squared L2 by the affine identity
    ``|q|^2 + |x|^2 - 2 (delta * (q . c) + min * sum(q))`` -> [B, N],
    clamped at 0; the only O(B*N*d) work is one ``q @ codes.T`` product."""
    q = q.to(torch.float32)
    if normsq is None:
        normsq = point_normsq(codes, scales)
    qdotc = q @ codes.to(torch.float32).T
    qdotx = scales[:, 1][None, :] * qdotc + scales[:, 0][None, :] * q.sum(
        dim=-1, keepdim=True
    )
    qsq = (q * q).sum(dim=-1, keepdim=True)
    return torch.clamp_min(qsq + normsq[None, :] - 2.0 * qdotx, 0.0)


def point_normsq(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """|x_j|^2 of each quantized point, float32[N]."""
    x = dequantize(codes, scales)
    return (x * x).sum(dim=-1)


def normalize(x: torch.Tensor) -> torch.Tensor:
    """Unit-normalize along the last axis (zero vectors pass through).

    Cosine similarity reduces to L2 over unit vectors
    (``|a - b|^2 = 2 - 2 cos(a, b)``), so every index takes
    ``metric="cosine"`` by normalizing at insert and query time."""
    x = x.to(torch.float32)
    n = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return x / torch.where(n > 0.0, n, 1.0)
