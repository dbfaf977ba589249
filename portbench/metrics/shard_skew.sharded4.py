"""How unevenly the shards' searches take the cards: over the traced
``ann_batch`` calls, the mean of (the slowest ``hnsw.sharded.shard``
span's device-clock seconds / the mean over the call's shards). 1.0 means
the shards are even."""

from portbench.lib.spans import CALL, in_calls, records, seconds

SHARD = "hnsw.sharded.shard"


def read(rec):
    recs = records(rec)
    if not recs:
        return None
    calls: dict = {}
    for r in in_calls(recs, SHARD, CALL):
        calls.setdefault(r["call"], []).append(seconds(r, "device"))
    skews = []
    for secs in calls.values():
        if None in secs or sum(secs) <= 0:
            return None
        skews.append(max(secs) * len(secs) / sum(secs))
    return sum(skews) / len(skews) if skews else None
