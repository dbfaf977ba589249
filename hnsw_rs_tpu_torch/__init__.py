"""hnsw_rs_tpu_torch — the PyTorch / CUDA port of ``hnsw_rs_tpu``.

The JAX package beside it is the reference; each module here has the
same name as its counterpart there. This package imports ``torch`` and
``numpy`` only. Devices are explicit: every class that holds device state
(``HNSW``, ``FlatIndex``, ``IVFFlatIndex``, ``IVFPQIndex``,
``HybridPagedHNSW``) takes one, ``ShardedHNSW`` and ``ReplicatedHNSW`` a
mesh of them, and nothing picks CUDA or CPU by
itself. The hand-written kernels (``csrc/*.cu``) are compiled with
``nvcc`` at first use into ``build/torch_kernels/`` (``ops.cuda_build``).

Layer map:
- ``ops``    — quantization, distances, (d2, id) ordering, the group-min
  and all-pairs L2 kernels with their plain versions, k-center cover
- ``graphs`` — layered dense adjacency with in-degree ledgers
- ``store``  — quantized point storage with poisoned capacity rows
- ``search`` — the lockstep flagged beam, hierarchical descent and
  pivot-seeded serving
- ``build`` / ``heuristic`` / ``build_cluster`` — the wave builder and
  the cluster-bulk builder
- ``store_paged`` — the paged on-disk block store and its streaming
  exact search
- ``models`` — ``HNSW``, ``FlatIndex``, ``IVFFlatIndex``, ``IVFPQIndex``
  and the out-of-core readers ``PagedHNSW`` / ``HybridPagedHNSW``
- ``parallel`` — the scale-out layer over a device mesh: ``ShardedHNSW``
  (one sub-graph per shard, top-k merge), ``ReplicatedHNSW`` (query
  data-parallelism) and the one-process-per-shard form on
  ``torch.distributed`` (``parallel.multihost``)
- ``utils``  — seeded and ann-benchmarks HDF5 datasets, GloVe loading and
  exact brute force, the reference-format codec (``utils.serializer``),
  logging and ``torch.profiler`` traces, progress bars, random vectors
  and ground-truth fixtures; ``eval_glove`` is the CLI
- ``native`` — the host helpers in C++ (``native/*.cpp``, built with
  ``g++`` at first use into ``build/native/``): the GloVe parser,
  positioned block reads, the paged tier's cold-row assembler, a host
  quantizer, and the single-core CPU HNSW baseline
- ``annb``   — ann-benchmarks adapters (``ANNBenchmarksHNSW``,
  ``ANNBenchmarksFlat``, ``ANNBenchmarksIVF``)
- ``entry``  — the entry points ``entry`` and ``dryrun_multichip`` (the
  twin of ``__graft_entry__.py``)
"""

from .models.flat import FlatIndex
from .models.hnsw import HNSW
from .models.ivf import IVFFlatIndex
from .params import Params, get_default_ml
from .store import PointStore

__all__ = ["FlatIndex", "HNSW", "IVFFlatIndex", "Params", "PointStore",
           "get_default_ml"]
