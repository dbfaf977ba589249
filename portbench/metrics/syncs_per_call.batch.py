"""Blocking host waits (stream, device and event synchronisations and
synchronous copies, from the profiler's runtime records) per
``ann_batch`` call in the traced span (``lib/trace.read_syncs_per_call``)."""

from portbench.lib.trace import read_syncs_per_call as read  # noqa: F401
