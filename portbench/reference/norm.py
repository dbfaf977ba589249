"""The unit-normalization rule, frozen here for the reference.

A copy of the rule the index applies under ``metric="cosine"`` to its
points at insert and to the queries at search, before the 8-bit rule
(cosine similarity is L2 over unit vectors, ``|a - b|^2 = 2 - 2 cos``):
float32, the square root of the sum of squares along the last axis, a
division tensor by tensor; a zero row passes through unchanged. Imports
nothing of the program.
"""

from __future__ import annotations

import torch


def normalize(x: torch.Tensor) -> torch.Tensor:
    """``x`` float[..., d] -> float32 unit rows (zero rows unchanged), in
    one piece, as the program normalizes each array it is handed. On the
    card the result depends on the row count: fewer than 16 rows at a
    time sum a row's squares in another order (at d=100, 849 of 10,000
    rows came out other in the last bit, 845 of them in a code), so it
    matches the program's queries only where each call sends 16 or more."""
    x = x.to(torch.float32)
    n = torch.sqrt((x * x).sum(dim=-1, keepdim=True))
    return x / torch.where(n > 0.0, n, 1.0)
