"""``qps`` in the probed cell, a metric of its own so that each cell's
bound follows its own spread."""

from portbench.metrics.qps import read  # noqa: F401
