"""Per-vector 8-bit scalar quantization (port of ``hnsw_rs_tpu/ops/quant.py``).

Each vector stores ``min`` and ``delta = (max - min) / 255`` plus uint8
codes ``floor((x - min) / delta + 0.5)``; the collection is two dense
tensors, ``codes`` uint8[N, d] and ``scales`` float32[N, 2] (min, delta).

Codes are bit-identical to the JAX package: IEEE f32 min, max, sub, div,
floor and clip. Every division here is tensor by tensor: PyTorch's CUDA
``a / python_scalar`` multiplies by the reciprocal, which can be one ulp
off true division.
"""

from __future__ import annotations

import numpy as np
import torch

BITS = 8
LEVELS = float(2**BITS - 1)  # 255


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` float[..., d] -> (codes uint8[..., d], scales float32[..., 2]).

    Matches the reference rounding (``vectors/src/quant.rs:41-66``); a
    constant vector (``delta == 0``) gets all-zero codes."""
    x = x.to(torch.float32)
    mn = x.amin(dim=-1, keepdim=True)
    mx = x.amax(dim=-1, keepdim=True)
    delta = (mx - mn) / torch.full_like(mx, LEVELS)
    pos = delta > 0.0
    t = torch.where(pos, (x - mn) / torch.where(pos, delta, 1.0), 0.0)
    codes = torch.clamp(torch.floor(t + 0.5), 0.0, LEVELS).to(torch.uint8)
    return codes, torch.cat([mn, delta], dim=-1)


def quantize_np(x) -> tuple[np.ndarray, np.ndarray]:
    """Host twin of :func:`quantize`: numpy in, numpy out, codes and
    scales bit for bit equal to it (the same IEEE f32 operations in the
    same order). From 1,024 rows on it takes the native single-pass
    quantizer (``native.quantize_rows``), as
    ``hnsw_rs_tpu/ops/quant.py:57-66`` does; numpy is its plain version.
    The build path quantizes on the index's device
    (``store.PointStore.from_vectors``); this is the host API."""
    x = np.asarray(x, np.float32)
    if x.ndim == 2 and x.shape[0] >= 1024:
        from ..native import quantize_rows

        out = quantize_rows(x)
        if out is not None:
            return out
    mn = np.min(x, axis=-1, keepdims=True)
    mx = np.max(x, axis=-1, keepdims=True)
    delta = (mx - mn) / np.float32(LEVELS)
    safe = np.where(delta > 0.0, delta, 1.0).astype(np.float32)
    t = np.where(delta > 0.0, (x - mn) / safe, 0.0).astype(np.float32)
    codes = np.clip(np.floor(t + np.float32(0.5)), 0.0, LEVELS).astype(np.uint8)
    scales = np.concatenate([mn, delta], axis=-1).astype(np.float32)
    return codes, scales


def dequantize(codes: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """``codes * delta + min`` -> float32[..., d]."""
    return codes.to(torch.float32) * scales[..., 1:2] + scales[..., 0:1]
