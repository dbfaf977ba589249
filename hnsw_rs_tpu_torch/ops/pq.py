"""Product-quantization primitives of the PQ-coded HNSW serving mode
(port of ``hnsw_rs_tpu/ops/pq.py``).

PQ splits a d-dim vector into ``m_pq`` contiguous subvectors and stores
one byte per subspace: the id of the nearest entry in that subspace's
codebook. Asymmetric distance computation (ADC) then needs a per-query
lookup table ``LUT[m, v] = |q_m - cb[m, v]|^2`` (one batched product
against the codebooks) and a table take along the code axis; no
candidate vector is fetched at all.

Codebooks are one dense ``f32[m_pq, nv, ds]`` tensor (every subspace
trains at once, each Lloyd step a batched product), codes are
``u8[N, m_pq]``. Plain tensor functions: they run on the device of their
inputs.

Where the JAX package scatter-adds the members of each cell, Lloyd's
step here multiplies by the one-hot assignment matrix: ``index_add_`` on
a GPU sums with atomics in no fixed order, so codebooks would differ
from run to run and codes would flip at ties, while a product sums in
one order every time. The ``[Ntrain, m_pq, nv]`` one-hot temp is the size
of the distance temp beside it.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pq_train", "pq_encode", "pq_decode", "train_pq", "encode_pq",
           "pq_lut", "adc_score", "adc_score16", "pack_nibbles",
           "unpack_nibbles", "opq_train"]


def _sub_d2(sub: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """[m, N, ds] x [m, nv, ds] -> expanded-form squared distances
    [m, N, nv] (not clamped: only the argmin is read)."""
    return ((sub * sub).sum(-1, keepdim=True)
            - 2.0 * torch.bmm(sub, cent.transpose(1, 2))
            + (cent * cent).sum(-1)[:, None, :])


def pq_train(res: torch.Tensor, init_idx: torch.Tensor, iters: int) -> torch.Tensor:
    """Train all m_pq sub-codebooks at once: ``res`` [N, m_pq, ds]
    (sub-)vectors, ``init_idx`` integer [nv] initial rows. Returns
    codebooks f32[m_pq, nv, ds]: batched Lloyd's, empty cells keep their
    previous centroid, ties go to the lowest cell."""
    sub = res.permute(1, 0, 2).contiguous()  # [m, N, ds]
    cent = sub[:, init_idx.long()]  # [m, nv, ds]
    nv = cent.shape[1]
    for _ in range(iters):
        a = _sub_d2(sub, cent).argmin(dim=2)  # [m, N]
        onehot = torch.nn.functional.one_hot(a, nv).to(torch.float32)
        sums = torch.bmm(onehot.transpose(1, 2), sub)  # [m, nv, ds]
        counts = onehot.sum(dim=1)  # [m, nv]
        cent = torch.where(counts[..., None] > 0,
                           sums / counts.clamp_min(1.0)[..., None], cent)
    return cent


def pq_encode(res: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """``res`` [N, m_pq, ds] -> codes u8[N, m_pq] (nearest codebook entry
    per subspace; ties go to the lowest id)."""
    sub = res.permute(1, 0, 2)
    return _sub_d2(sub, codebooks).argmin(dim=2).T.to(torch.uint8).contiguous()


def _init_rows(n: int, nv: int, seed: int) -> np.ndarray:
    """The deterministic ``nv``-row initial draw (row 0 repeated when the
    collection is smaller than the codebook)."""
    rng = np.random.default_rng(seed)
    init = rng.choice(n, size=min(nv, n), replace=False).astype(np.int32)
    if n < nv:
        init = np.concatenate([init, np.zeros(nv - n, np.int32)])
    return init


def train_pq(x: torch.Tensor, m_pq: int, iters: int = 12, seed: int = 0,
             nv: int = 256) -> torch.Tensor:
    """:func:`pq_train` for flat [N, d] input: reshapes into subspaces
    and draws a deterministic ``nv``-row init. ``nv=16`` trains 4-bit
    sub-codebooks (:func:`adc_score16`)."""
    n, d = x.shape
    if d % m_pq != 0:
        raise ValueError(f"m_pq {m_pq} must divide dim {d}")
    init = torch.from_numpy(_init_rows(n, nv, seed)).to(x.device)
    res = x.to(torch.float32).reshape(n, m_pq, d // m_pq)
    return pq_train(res, init, iters)


def encode_pq(x: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Flat [N, d] -> u8[N, m_pq] against :func:`train_pq` codebooks."""
    n, d = x.shape
    m_pq = codebooks.shape[0]
    return pq_encode(x.to(torch.float32).reshape(n, m_pq, d // m_pq), codebooks)


def pq_decode(codes: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """codes u8[N, m_pq] -> reconstructed f32[N, m_pq * ds] (each
    subspace's codebook entry, concatenated)."""
    n, m_pq = codes.shape
    sub = torch.arange(m_pq, device=codes.device)[None, :]
    return codebooks[sub, codes.long()].reshape(n, -1)


def opq_train(x: torch.Tensor, m_pq: int, pq_iters: int = 8, opq_iters: int = 6,
              seed: int = 0, train_n: int = 131072, nv: int = 256):
    """OPQ (Ge et al., CVPR'13): learn an orthogonal rotation ``R`` so the
    PQ subspace split loses less energy, by alternating PQ train + encode
    in the rotated space with the orthogonal-Procrustes update
    ``R = U V^T`` from ``svd(x^T x_hat)``.

    ``x`` f32[N, d] (an evenly strided subsample of at most ``train_n``
    rows is used). Returns ``(R f32[d, d], codebooks f32[m_pq, nv, ds])``:
    encoding is ``pq_encode((x @ R).reshape(n, m_pq, ds), codebooks)`` and
    queries build their LUTs from ``q @ R``."""
    n, d = x.shape
    if d % m_pq != 0:
        raise ValueError(f"m_pq {m_pq} must divide dim {d}")
    if n > train_n:
        sel = np.linspace(0, n - 1, train_n).round().astype(np.int64)
        x = x[torch.from_numpy(sel).to(x.device)]
        n = train_n
    x = x.to(torch.float32)
    init = torch.from_numpy(_init_rows(n, nv, seed)).to(x.device)
    rot = torch.eye(d, dtype=torch.float32, device=x.device)
    for _ in range(max(opq_iters, 1)):
        res = (x @ rot).reshape(n, m_pq, d // m_pq)
        cb = pq_train(res, init, pq_iters)
        xhat = pq_decode(pq_encode(res, cb), cb)  # [n, d] in rotated space
        u, _, vt = torch.linalg.svd(x.T @ xhat)
        rot = u @ vt
    # final codebooks against the final rotation
    cb = pq_train((x @ rot).reshape(n, m_pq, d // m_pq), init, pq_iters)
    return rot, cb


def pq_lut(q: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """Per-query ADC lookup table ``f32[B, m_pq, nv]``:
    ``LUT[b, m, v] = |q_m - cb[m, v]|^2`` through one batched product
    (the cross term)."""
    b = q.shape[0]
    m_pq, _, ds = codebooks.shape
    qs = q.to(torch.float32).reshape(b, m_pq, ds)
    cross = torch.einsum("bms,mvs->bmv", qs, codebooks)
    cbn = (codebooks * codebooks).sum(-1)  # [m_pq, nv]
    return (qs * qs).sum(-1)[..., None] - 2.0 * cross + cbn[None]


def adc_score(lut: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Approximate squared L2 of candidates against their query's LUT:
    ``lut`` f32[B, m_pq, nv], ``codes`` u8[B, C, m_pq] -> f32[B, C]
    (the sum of the subspace terms, clamped at 0)."""
    got = lut.gather(2, codes.long().transpose(1, 2))  # [B, m_pq, C]
    return got.sum(dim=1).clamp_min(0.0)


def pack_nibbles(codes: torch.Tensor) -> torch.Tensor:
    """4-bit codes u8[..., m] (values < 16, m even) -> u8[..., m // 2].
    Subspace ``2j`` lives in byte ``j``'s low nibble, ``2j+1`` in its
    high nibble."""
    lo = codes[..., 0::2].to(torch.uint8)
    hi = codes[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_nibbles(packed: torch.Tensor) -> torch.Tensor:
    """u8[..., mb] -> u8[..., 2 * mb] 4-bit codes."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1], -1)


def adc_score16(lut: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """ADC over 4-bit codes: ``lut`` f32[B, m, 16] (from :func:`pq_lut`
    with 16-entry codebooks), ``packed`` u8[B, C, m // 2] nibble-packed
    codes -> f32[B, C]. The JAX package looks the 16 entries up with an
    unrolled compare-select because gathers are slow on a TPU; a gather
    reads the same entries here, and the terms are summed over the
    subspaces in the same [B, C, m] layout."""
    codes = unpack_nibbles(packed).long()  # [B, C, m]
    got = lut.gather(2, codes.transpose(1, 2)).transpose(1, 2)  # [B, C, m]
    return got.sum(dim=-1).clamp_min(0.0)
