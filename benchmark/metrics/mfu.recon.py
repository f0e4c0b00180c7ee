"""A reconstruction step's model FLOPs (the field's heads: the coarse pass forward, the fine pass forward and backward) over the traced window, at the bf16 peak, %."""

from benchmark.lib import readers


def read(r):
    return readers.mfu(r)
