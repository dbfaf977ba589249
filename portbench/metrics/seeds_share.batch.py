"""Share of the traced ``ann_batch`` calls' device-clock time in the pivot
seed stage (``hnsw.search.seeds``: the [B, P] product and top-ef)."""

from portbench.lib.spans import stage_share


def read(rec):
    return stage_share(rec, "hnsw.search.seeds")
