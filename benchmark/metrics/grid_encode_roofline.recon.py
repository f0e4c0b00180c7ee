"""The grid encode's least time, counted for the algorithm (8 corners a level, the table read once and its gradient written once), over its device ms a step, %."""

from benchmark.lib import readers


def read(r):
    return readers.span_roofline(r, "grid_encode")
