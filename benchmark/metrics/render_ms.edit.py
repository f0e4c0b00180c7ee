"""Device ms of the training render (render_rays_fast: march, compaction, tri-plane encode, K1, composite) of an editing step, forward, on that step's inputs."""

from benchmark.lib import readers


def read(r):
    return readers.span_ms(r, "render")
