"""Kernel launches per single-query request in the traced span: the
kernels the profiler saw start on the device (one per launch, whatever
API launched it)."""

from portbench.lib.trace import count_kernels, has_device


def read(rec):
    tr = rec.get("trace")
    if not tr or not has_device(tr) or not rec.get("traced_queries"):
        return None
    return count_kernels(tr) / rec["traced_queries"]
