"""K1 (csrc/fused_mlp.cu) in the traced editing window: the least time of its launches over their kernels' device time, %."""

from benchmark.lib import readers


def read(r):
    return readers.kernel_roofline(r, "k1", readers.K1_KERNELS)
