"""``syncs_per_call.batch`` in the probed cell, which reports ``qps.probed``
(``lib/trace.read_syncs_per_call``)."""

from portbench.lib.trace import read_syncs_per_call as read  # noqa: F401
