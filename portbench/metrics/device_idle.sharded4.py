"""The cards' idle share over the traced span, the mean over the cell's
four cards (``lib/trace.read_idle``)."""

from portbench.lib.trace import read_idle as read  # noqa: F401
