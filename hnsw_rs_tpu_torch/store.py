"""Quantized point storage (port of ``hnsw_rs_tpu/store.py``).

Three dense arrays: ``codes`` uint8[C, d] and ``scales`` float32[C, 2] on
the index's device, and ``levels`` int32[C] on the host. Ids are row
positions. The arrays may carry capacity ``C`` beyond the live count
``len(store)``, so that incremental inserts grow them in powers of two.
Capacity rows are poisoned: ``scales = (POISON_MIN, 0)`` dequantizes them
to a point astronomically far from everything and ``levels = -1`` keeps
them out of every layer, so the direct-form distance consumers (search,
brute force, compliance) take the capacity arrays unchanged. The affine
form does not: a poisoned row's |x|^2 is d * 1e36, which overflows
float32 above d ~ 340, so ``FlatIndex`` and the kernels take live rows
only.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.distance import l2sq, l2sq_quant
from .ops.quant import dequantize, quantize

MAX_LEVEL = 31  # safety cap; with ml = 1/ln(m) real levels stay far below
POISON_MIN = 1.0e18  # capacity-row dequant value: never a top-k neighbor


def sample_levels(n: int, ml: float, seed: int = 0) -> np.ndarray:
    """Geometric level sampling, ``floor(-ln(u) * ml)``, u in (0, 1),
    deterministic in ``seed``. A copy of ``hnsw_rs_tpu.store.sample_levels``:
    the same seed gives the same levels in both packages."""
    rng = np.random.default_rng(seed)
    u = rng.random(n)
    while np.any(u == 0.0):
        u[u == 0.0] = rng.random(int(np.sum(u == 0.0)))
    levels = np.floor(-np.log(u) * ml).astype(np.int32)
    return np.minimum(levels, MAX_LEVEL)


class PointStore:
    """Dense quantized point collection (the ``SimplePoints`` analogue)."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor, levels,
                 n: int | None = None):
        self.codes = codes  # uint8[C, d], C = capacity
        self.scales = scales  # f32[C, 2]
        self.levels = np.asarray(levels, np.int32)  # host metadata, len C
        self._n = int(codes.shape[0]) if n is None else int(n)

    @classmethod
    def empty(cls, dim: int, device: torch.device | str) -> "PointStore":
        return cls(torch.zeros((0, dim), dtype=torch.uint8, device=device),
                   torch.zeros((0, 2), dtype=torch.float32, device=device),
                   np.zeros((0,), np.int32))

    @classmethod
    def from_vectors(
        cls, vectors, ml: float, device: torch.device | str, seed: int = 0
    ) -> "PointStore":
        """Quantize (on ``device``) and level-sample a batch of float
        vectors (``SimplePoints::new``, ``points/src/points.rs:39-48``)."""
        x = torch.as_tensor(vectors, dtype=torch.float32, device=device)
        codes, scales = quantize(x)
        return cls(codes, scales, sample_levels(x.shape[0], ml, seed))

    def __len__(self) -> int:
        return self._n

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def capacity(self) -> int:
        return int(self.codes.shape[0])

    @property
    def dim(self) -> int | None:
        """Vector dimension, or None while the store is empty."""
        return int(self.codes.shape[1]) if len(self) else None

    def ids(self) -> np.ndarray:
        """Live ids, int32[len(self)] (ids are row positions)."""
        return np.arange(len(self), dtype=np.int32)

    def _grow_to(self, cap: int) -> None:
        """Grow the capacity arrays to ``cap`` rows, poisoning the pads."""
        old = self.capacity
        if cap <= old:
            return
        d = self.codes.shape[1]
        codes = torch.zeros((cap, d), dtype=torch.uint8, device=self.device)
        scales = torch.tensor([[POISON_MIN, 0.0]], dtype=torch.float32,
                              device=self.device).repeat(cap, 1)
        codes[:old] = self.codes
        scales[:old] = self.scales
        self.codes, self.scales = codes, scales
        self.levels = np.concatenate(
            [self.levels, np.full((cap - old,), -1, np.int32)])

    def push(self, vector, level: int) -> int:
        """Append one point with an explicit level, re-iding it to the
        tail position (``SimplePoints::push``, ``points/src/points.rs:
        64-73``). Returns the new id."""
        x = torch.as_tensor(vector, dtype=torch.float32,
                            device=self.device).reshape(1, -1)
        other = PointStore(*quantize(x), np.asarray([level], np.int32))
        return int(self.extend(other)[0])

    def extend(self, other: "PointStore") -> np.ndarray:
        """Append another store, re-iding its points to tail positions
        (``SimplePoints::extend``, ``points/src/points.rs:103-116``).
        Returns the new ids. Capacity grows to the next power of two (at
        least 64); a bulk extend into an empty store stays exactly sized."""
        start = len(self)
        k = len(other)
        need = start + k
        if start == 0 and self.capacity == 0:
            self.codes = other.codes[:k]
            self.scales = other.scales[:k]
            self.levels = np.asarray(other.levels[:k], np.int32)
            self._n = k
            return np.arange(k, dtype=np.int32)
        if need > self.capacity:
            self._grow_to(max(1 << (need - 1).bit_length(), 64))
        self.codes[start:need] = other.codes[:k]
        self.scales[start:need] = other.scales[:k]
        self.levels[start:need] = other.levels[:k]
        self._n = need
        return np.arange(start, need, dtype=np.int32)

    def get_values(self, idx) -> np.ndarray:
        """Dequantized float values of point(s) ``idx``
        (``Point::get_vals``)."""
        return dequantize(self.codes[idx], self.scales[idx]).cpu().numpy()

    def distance(self, a: int, b: int) -> float:
        """True L2 between stored (quantized) points ``a`` and ``b``
        (``SimplePoints::distance``, ``points/src/points.rs:88-96``)."""
        x = dequantize(self.codes[[a, b]], self.scales[[a, b]])
        return float(torch.sqrt(l2sq(x[0], x[1])))

    def distance_to_vector(self, vector, idx: int) -> float:
        """L2 from a raw vector to point ``idx``; the vector is quantized
        and dequantized first, as the reference quantizes every query
        (``template.rs:313``, ``SimplePoints::distance2point``)."""
        x = torch.as_tensor(np.asarray(vector, np.float32), device=self.device)
        q = dequantize(*quantize(x))
        return float(torch.sqrt(l2sq_quant(q, self.codes[idx], self.scales[idx])))
