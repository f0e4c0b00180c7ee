"""The FLUX transformer call's least time (its FLOPs from ``jobs/edit_flux.py::flux_counts`` at the bf16 peak, or its bytes at the HBM peak) over its device time, %."""

from benchmark.lib import readers


def read(r):
    return readers.span_roofline(r, "unet")
