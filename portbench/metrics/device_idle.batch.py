"""The device's idle share over the traced span (``lib/trace.read_idle``)."""

from portbench.lib.trace import read_idle as read  # noqa: F401
