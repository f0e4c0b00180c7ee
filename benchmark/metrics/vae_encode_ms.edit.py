"""Device ms of the VAE encoder's forward in an editing step (one 512x512 image), timed on that step's inputs behind a sleep kernel."""

from benchmark.lib import readers


def read(r):
    return readers.span_ms(r, "vae_encode")
