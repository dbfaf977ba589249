"""Share of the traced ``ann_batch`` calls' device-clock time in the probe
stage (``hnsw.search.probe``: the probed shortlists scored and the pool
reduced to ef)."""

from portbench.lib.spans import stage_share


def read(rec):
    return stage_share(rec, "hnsw.search.probe")
