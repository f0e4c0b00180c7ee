"""An editing step's model FLOPs (UNet forward at batch 2, VAE encoder forward and backward at 512², the field's heads forward and backward) over the traced window, at the bf16 peak, %."""

from benchmark.lib import readers


def read(r):
    return readers.mfu(r)
