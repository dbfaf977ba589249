"""Share of the traced single-query calls' device-clock time in the
layer-0 beam (``hnsw.search.beam``, the whole loop)."""

from portbench.lib.spans import stage_share


def read(rec):
    return stage_share(rec, "hnsw.search.beam")
