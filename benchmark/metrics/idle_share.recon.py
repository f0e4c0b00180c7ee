"""Share of the traced reconstruction window in which no operation runs on the card (the union of kernel intervals), %."""

from benchmark.lib import readers


def read(r):
    return readers.idle_share(r)
