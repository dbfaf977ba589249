"""The per-vector 8-bit rule, frozen here for the reference.

A copy of the rule the index stores its points in (the Rust reference's
``vectors/src/quant.rs:41-66``): each vector keeps ``min`` and
``delta = (max - min) / 255`` and codes ``floor((x - min) / delta +
0.5)`` clipped to [0, 255]; a constant vector gets all-zero codes. The
divisions are tensor by tensor, as IEEE float32 division, so the codes
are those the index holds bit for bit. Under ``metric="cosine"`` the
index unit-normalizes first (``norm.py``). Imports nothing of the program.
"""

from __future__ import annotations

import torch

from .norm import normalize

LEVELS = 255.0
METRICS = ("l2", "cosine")


def stored(x: torch.Tensor, metric: str) -> torch.Tensor:
    """``x`` float[N, d] -> the vectors the index stores and compares
    under ``metric``: the 8-bit rule, after unit normalization for
    ``"cosine"``. Points and queries alike."""
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; the index knows {METRICS}")
    return quantize_dequantize(normalize(x) if metric == "cosine" else x)


def quantize_dequantize(x: torch.Tensor, block: int = 1 << 18) -> torch.Tensor:
    """``x`` float[N, d] -> the stored vectors ``codes * delta + min`` as
    float32[N, d], in row blocks."""
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for lo in range(0, x.shape[0], block):
        v = x[lo:lo + block].to(torch.float32)
        mn = v.amin(dim=-1, keepdim=True)
        mx = v.amax(dim=-1, keepdim=True)
        delta = (mx - mn) / torch.full_like(mx, LEVELS)
        pos = delta > 0.0
        t = torch.where(pos, (v - mn) / torch.where(pos, delta, 1.0), 0.0)
        codes = torch.clamp(torch.floor(t + 0.5), 0.0, LEVELS)
        out[lo:lo + block] = codes * delta + mn
    return out
