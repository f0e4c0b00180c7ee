"""The UNet call's least time (FLOPs at the bf16 peak or bytes at the HBM peak) over its device time, %."""

from benchmark.lib import readers


def read(r):
    return readers.span_roofline(r, "unet")
