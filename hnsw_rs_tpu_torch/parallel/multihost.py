"""Multi-process execution on ``torch.distributed`` (port of
``hnsw_rs_tpu/parallel/multihost.py``).

The reference is strictly single-process (its whole communication layer
is shared memory and mutexes, ``hnsw/src/template.rs:422-439``). The
scale-out form for BASELINE configs 4-5 runs one process per shard group:
every rank holds its own shards' rows, searches them, and one
``all_gather`` of each rank's (distance, id) top-k blocks plus one
(dist, id) sort merges them — the collective the JAX package's
``shard_map`` merge rides. Both forms return the same ids
(``sharded.sharded_query`` is the in-process form).

NCCL refuses two ranks on one device, so on a machine with one card the
NCCL form runs at world size 1; the gloo backend runs any world size on
the CPU. Run a rank of the smoke worker with::

    python -m hnsw_rs_tpu_torch.parallel.multihost --device cuda:0 \\
        --coordinator tcp://localhost:PORT --world 1 --rank 0 \\
        --index DIR --queries Q.npy --out IDS.npy

(``ShardedHNSW.save`` wrote ``DIR``; every rank reads only its own
shards' rows from it onto ``--device``, answers the queries with the rank
form, and rank 0 writes the merged ids.) ``--device`` has no default; the
backend follows it (NCCL for a CUDA device, gloo for the CPU) unless
``--backend`` names one.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops.quant import dequantize, quantize
from .mesh import Mesh
from .sharded import _local_search, merge_topk


def init_distributed(coordinator_address: str, num_processes: int,
                     process_id: int, backend: str) -> None:
    """Join the process group (idempotent). ``coordinator_address`` is a
    ``tcp://host:port`` that every rank reaches; ``backend`` is ``"nccl"``
    or ``"gloo"``. Nothing is detected from the environment."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id)


def global_mesh(device, n_data: int = 1, n_shard: int | None = None) -> Mesh:
    """The (data, shard) mesh over all ranks, rank ``i * n_shard + j`` at
    cell ``[i, j]``. A rank addresses only its own device, so every cell
    of the returned grid holds ``device``."""
    world = dist.get_world_size()
    if n_shard is None:
        n_shard = world // n_data
    need = n_data * n_shard
    if world < need:
        raise ValueError(f"need {need} ranks, have {world}")
    grid = np.empty((n_data, n_shard), dtype=object)
    grid[:] = torch.device(device)
    return Mesh(grid)


def shard_from_local(mesh: Mesh, local_rows) -> torch.Tensor:
    """This rank's share of a sharded array: its own rows, on its device
    (the multi-host replacement for placing a whole array, which would
    need every device to be addressable)."""
    return torch.as_tensor(np.asarray(local_rows), device=mesh.devices[0, 0])


def local_shards(path: str, mesh: Mesh, shards) -> list:
    """Read the ``shards`` of a ``ShardedHNSW.save`` directory onto this
    rank's device, and keep nothing else of it: a list of (adjs, codes,
    scales, gids, ep) per shard, adjacency layer 0 first."""
    with open(os.path.join(path, "params.json")) as f:
        n_layers = int(json.load(f)["n_layers"])
    shards = list(shards)
    with np.load(os.path.join(path, "arrays.npz")) as z:
        # a compressed npz member is read whole: take each one once
        part = {name: z[name][shards] for name in
                ["codes", "scales", "gids", "eps"]
                + [f"adj_{i}" for i in range(n_layers)]}
    return [([shard_from_local(mesh, part[f"adj_{i}"][j]) for i in range(n_layers)],
             shard_from_local(mesh, part["codes"][j]),
             shard_from_local(mesh, part["scales"][j]),
             shard_from_local(mesh, part["gids"][j]), int(part["eps"][j]))
            for j in range(len(shards))]


def rank_sharded_query(local, q, ef: int, k: int, max_iters: int, group=None):
    """The rank form of ``sharded.sharded_query``: this rank searches its
    shards ``local`` (from :func:`local_shards`, in shard order) for the
    whole batch ``q``, then one ``all_gather`` of every rank's (d, id)
    blocks over ``group`` and one (dist, id) sort. Every rank must hold
    the same number of shards, contiguous in rank order. Returns
    (distances [B, k], global ids [B, k]) on every rank."""
    parts = [_local_search(adjs, codes, scales, gids, ep, q, ef, k, max_iters)
             for adjs, codes, scales, gids, ep in local]
    d = torch.cat([p[0] for p in parts], dim=1).contiguous()
    i = torch.cat([p[1] for p in parts], dim=1).contiguous()
    world = dist.get_world_size(group)
    all_d = [torch.empty_like(d) for _ in range(world)]
    all_i = [torch.empty_like(i) for _ in range(world)]
    dist.all_gather(all_d, d, group=group)
    dist.all_gather(all_i, i, group=group)
    return merge_topk(list(zip(all_d, all_i)), k, q.device)


def _worker(argv=None) -> None:
    ap = argparse.ArgumentParser(description="one rank of the sharded query")
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--index", required=True, help="a ShardedHNSW.save directory")
    ap.add_argument("--queries", required=True, help="float32 [B, d] .npy")
    ap.add_argument("--out", required=True, help="rank 0 writes the ids here")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--ef", type=int, default=48)
    ap.add_argument("--device", required=True, help="cuda:N or cpu")
    ap.add_argument("--backend", choices=["nccl", "gloo"],
                    help="default: nccl on a CUDA device, gloo on the CPU")
    a = ap.parse_args(argv)
    backend = a.backend or ("nccl" if torch.device(a.device).type == "cuda" else "gloo")
    init_distributed(a.coordinator, a.world, a.rank, backend)
    try:
        mesh = global_mesh(a.device)
        with open(os.path.join(a.index, "params.json")) as f:
            n_shards = int(json.load(f)["n_shards"])
        if n_shards % a.world:
            raise ValueError(f"{n_shards} shards do not split over {a.world} ranks")
        per = n_shards // a.world
        local = local_shards(a.index, mesh, range(a.rank * per, (a.rank + 1) * per))
        x = torch.from_numpy(np.load(a.queries).astype(np.float32)).to(mesh.devices[0, 0])
        q = dequantize(*quantize(x))
        _, ids = rank_sharded_query(local, q, a.ef, a.k, 2 * a.ef + 16)
        if a.rank == 0:
            np.save(a.out, ids.cpu().numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker()
