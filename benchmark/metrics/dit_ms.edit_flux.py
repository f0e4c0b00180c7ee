"""Device ms of the FLUX transformer's call in an editing step (batch 1, 4,096 image and 512 text tokens), timed on that step's inputs behind a sleep kernel: the harness's span of the guidance's denoiser, which the port keeps under ``unet``."""

from benchmark.lib import readers


def read(r):
    return readers.span_ms(r, "unet")
