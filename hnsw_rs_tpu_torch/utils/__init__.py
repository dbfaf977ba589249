"""Host-side utilities: datasets and ground truth, progress, logging,
CLI arguments and the reference-format codec (``serializer``)."""

from .data import load_bf_data, save_bf_data, split
from .glove import brute_force_nns, load_glove_array
from .logging import (count, counters, get_logger, profile_trace, reset_spans,
                      span, timed, traced_spans)
from .progress import ProgressBar, progress_iter
from .rand import gen_rand_vecs

__all__ = [
    "brute_force_nns",
    "load_glove_array",
    "ProgressBar",
    "progress_iter",
    "gen_rand_vecs",
    "split",
    "save_bf_data",
    "load_bf_data",
    "get_logger",
    "profile_trace",
    "timed",
    "span",
    "count",
    "counters",
    "traced_spans",
    "reset_spans",
]
