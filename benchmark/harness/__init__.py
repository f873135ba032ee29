"""The benchmark's harness: what a run loads by name, the data, the
weights, the timed window, the trace, the yardstick and the comparison
that decides ``correct``."""
