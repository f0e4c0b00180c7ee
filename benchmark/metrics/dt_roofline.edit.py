"""dT (csrc/triplane_dtable.cu) in the traced editing window: the least time of its launches over their kernels' device time, %."""

from benchmark.lib import readers


def read(r):
    return readers.kernel_roofline(r, "dt", readers.DT_KERNELS)
