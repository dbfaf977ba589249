"""The Gaussian-mixture stand-in, drawn on the card from the seed.

The rule of ``hnsw_rs_tpu_torch/utils/datasets.synthetic_clustered``
(centers uniform in [0, 1)^d, points and queries a center plus
N(0, noise^2) per component), with one change so that every seed does
the same amount of work: cluster sizes are not drawn but fixed (the N
points split as evenly as the cluster count allows, the queries spread
over the clusters the same way), and the seed draws which point and
query lands in which cluster. A ``torch.Generator`` on the device makes
everything in a few large calls.
"""

from __future__ import annotations

import torch

from portbench.lib.seeds import generator


def even_assign(n: int, clusters: int, g, device) -> torch.Tensor:
    """Cluster of each of ``n`` items: each cluster ``n // clusters`` or one
    more, in an order drawn from ``g``."""
    a = torch.arange(n, device=device) % clusters
    return a[torch.randperm(n, generator=g, device=device)]


def make(spec: dict, seed: int, device: torch.device):
    """(points float32[N, d], queries float32[Q, d]) on ``device``."""
    n, d, nq = spec["points"], spec["dim"], spec["queries"]
    nc, noise = spec["clusters"], spec["noise"]
    g = generator(seed, "clustered", device)
    centers = torch.rand((nc, d), generator=g, device=device)
    a = even_assign(n, nc, g, device)
    train = centers[a]
    train += noise * torch.randn((n, d), generator=g, device=device)
    qa = even_assign(nq, nc, g, device)
    queries = centers[qa] + noise * torch.randn((nq, d), generator=g,
                                                device=device)
    return train, queries
