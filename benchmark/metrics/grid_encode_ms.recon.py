"""Device ms a reconstruction step spends in the grid encode: the coarse pass forward, the fine pass forward and backward, on that step's points."""

from benchmark.lib import readers


def read(r):
    return readers.span_ms(r, "grid_encode")
