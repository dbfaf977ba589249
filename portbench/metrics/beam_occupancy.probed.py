"""Live lanes over lane-iterations of the traced calls' beams:
``beam.live_lanes`` / (``beam.iterations`` x batch), the share of the lockstep
loop's query slots whose query had not yet converged."""

from portbench.lib.spans import ratio

read = ratio("beam.live_lanes", "lanes")
