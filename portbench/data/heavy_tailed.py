"""The heavy-tailed stand-in, drawn on the card from the seed.

The rule of ``hnsw_rs_tpu_torch/utils/datasets.synthetic_heavy_tailed``:
Zipf cluster sizes, p(c) ~ 1 / (rank + 10); a per-cluster scale of
0.05 * 0.5 * 8^u (x0.5 to x4); 80% of the queries from clusters drawn by
the same weights and 20% from the rarest half. So that every seed does
the same amount of work, the sizes and scales are fixed sets and the
seed draws only their order: each cluster's point count is its share of
N rounded by largest remainder, the scales are the evenly spaced
quantiles u = (j + 0.5) / C dealt to the clusters in a drawn order, the
head queries are split over the clusters the same way, and the tail
queries take distinct clusters of the rarest half.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib.seeds import generator


def shares(total: int, weights: np.ndarray) -> np.ndarray:
    """``total`` split by ``weights``: floors plus one for the largest
    remainders (the same counts for every seed)."""
    exact = total * weights / weights.sum()
    counts = np.floor(exact).astype(np.int64)
    rest = total - int(counts.sum())
    counts[np.argsort(-(exact - counts), kind="stable")[:rest]] += 1
    return counts


def make(spec: dict, seed: int, device: torch.device):
    """(points float32[N, d], queries float32[Q, d]) on ``device``."""
    n, d, nq, nc = spec["points"], spec["dim"], spec["queries"], spec["clusters"]
    g = generator(seed, "heavy_tailed", device)
    w = 1.0 / (np.arange(nc) + 10.0)
    centers = torch.rand((nc, d), generator=g, device=device)
    u = (torch.arange(nc, device=device, dtype=torch.float32) + 0.5) / nc
    scales = (0.5 * 8.0 ** u * 0.05)[torch.randperm(nc, generator=g,
                                                    device=device)]
    sizes = torch.from_numpy(shares(n, w)).to(device)
    a = torch.repeat_interleave(torch.arange(nc, device=device), sizes)
    a = a[torch.randperm(n, generator=g, device=device)]
    train = torch.randn((n, d), generator=g, device=device)
    train *= scales[a, None]
    train += centers[a]
    nq_tail = nq // 5
    head = torch.repeat_interleave(
        torch.arange(nc, device=device),
        torch.from_numpy(shares(nq - nq_tail, w)).to(device))
    n_rare = nc - nc // 2
    tail = nc // 2 + torch.randperm(n_rare, generator=g, device=device)[
        torch.arange(nq_tail, device=device) % n_rare]
    qa = torch.cat([head, tail])
    qa = qa[torch.randperm(nq, generator=g, device=device)]
    queries = centers[qa] + torch.randn((nq, d), generator=g,
                                        device=device) * scales[qa, None]
    return train, queries
