"""Index model families: exact flat search, the HNSW graph index,
IVF-Flat and IVF-PQ (inverted files), and the out-of-core paged HNSW
readers."""

from .flat import FlatIndex
from .hnsw import HNSW
from .ivf import IVFFlatIndex
from .ivfpq import IVFPQIndex
from .paged import HybridPagedHNSW, PagedHNSW, save_paged

__all__ = ["FlatIndex", "HNSW", "HybridPagedHNSW", "IVFFlatIndex",
           "IVFPQIndex", "PagedHNSW", "save_paged"]
