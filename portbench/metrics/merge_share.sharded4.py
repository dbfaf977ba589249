"""Share of the traced ``ann_batch`` calls' device-clock time in the
cross-card merge (``hnsw.sharded.merge``: every shard's top-k copied to
the data device and merged there); None where the calls open no merge
span (a program older than it)."""

from portbench.lib.spans import CALL, in_calls, records, stage_share

MERGE = "hnsw.sharded.merge"


def read(rec):
    recs = records(rec)
    if not recs or not in_calls(recs, MERGE, CALL):
        return None
    return stage_share(rec, MERGE)
