"""New neighbors over fetched neighbors in the traced calls' beams:
``beam.rows_new`` / ``beam.rows_fetched``, the valid entries of the expanded
rows that were neither in the beam nor the ring of recent ids."""

from portbench.lib.spans import ratio

read = ratio("beam.rows_new", "beam.rows_fetched")
