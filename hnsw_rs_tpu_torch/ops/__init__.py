"""Numeric building blocks of the port (the reference's ``vectors``
crate): quantization, distances, PQ, and (d2, id) ordering primitives;
the CUDA kernels' wrappers live in ``groupmin`` and ``l2_kernel``."""

from .distance import (
    l2,
    l2sq,
    l2sq_quant,
    normalize,
    pairwise_l2sq_exact,
    pairwise_l2sq_mxu,
    point_normsq,
)
from .pq import adc_score, encode_pq, pq_lut, train_pq
from .quant import BITS, LEVELS, dequantize, quantize
from .topk import INF, PAD_ID, SENTINEL, dedup_ids, mask_invalid, sort_dist_id, topk_dist_id

__all__ = [
    "adc_score",
    "encode_pq",
    "pq_lut",
    "train_pq",
    "BITS",
    "LEVELS",
    "INF",
    "PAD_ID",
    "SENTINEL",
    "quantize",
    "dequantize",
    "l2",
    "normalize",
    "l2sq",
    "l2sq_quant",
    "pairwise_l2sq_exact",
    "pairwise_l2sq_mxu",
    "point_normsq",
    "sort_dist_id",
    "topk_dist_id",
    "mask_invalid",
    "dedup_ids",
]
