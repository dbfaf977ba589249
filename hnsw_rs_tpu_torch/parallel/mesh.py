"""Device meshes (port of ``hnsw_rs_tpu/parallel/mesh.py``).

A mesh is a ``[n_data, n_shard]`` grid of ``torch.device`` with two axes,
as in the JAX package:

- ``data``  — query data-parallelism: a batch of queries is split over
  the rows of the grid, the index replicated (the serving fan-out).
- ``shard`` — index partitioning: shard ``s`` of a sharded index lives on
  the devices of column ``s``; a query fans out to every shard and the
  per-shard top-k results are merged (the memory scale-out).

A device may repeat: eight shards on one card is a mesh of ``cuda:0``
eight times, and every step then runs the shards one after another on
that card. Where the JAX package runs one ``shard_map`` program over the
grid, the port loops over its cells in one process; ``parallel.multihost``
is the form with one process per shard.
"""

from __future__ import annotations

import numpy as np
import torch


class Mesh:
    """A ``[n_data, n_shard]`` grid of devices."""

    axis_names = ("data", "shard")

    def __init__(self, devices: np.ndarray):
        self.devices = np.asarray(devices, dtype=object)
        if self.devices.ndim != 2:
            raise ValueError("a mesh is a [n_data, n_shard] grid of devices")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def data_devices(self) -> list[torch.device]:
        """The device each data row's slice of a query batch runs on
        (column 0 of the grid)."""
        return list(self.devices[:, 0])

    @property
    def shard_devices(self) -> list[torch.device]:
        """The device each shard's state lives on (row 0 of the grid)."""
        return list(self.devices[0, :])


def make_mesh(n_data: int, n_shard: int, devices) -> Mesh:
    """A (data, shard) mesh over the first ``n_data * n_shard`` of
    ``devices`` (a device may repeat)."""
    devices = [torch.device(d) for d in devices]
    need = n_data * n_shard
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty((n_data, n_shard), dtype=object)
    for i, d in enumerate(devices[:need]):
        grid[i // n_shard, i % n_shard] = d
    return Mesh(grid)
