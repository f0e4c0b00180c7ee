"""Device ms of the UNet's call in an editing step (CFG batch 2 at 64x64 latents), timed on that step's inputs behind a sleep kernel."""

from benchmark.lib import readers


def read(r):
    return readers.span_ms(r, "unet")
