"""Editing, ``bear.sh`` phase 2: LGIE/SDS steps on the port's ``Trainer``
built with ``--pretrained`` and the SD guidance, K steps a dispatch through
``engine/editing.py::editing_steps_many``."""

from __future__ import annotations

import contextlib

from benchmark.lib import counts
from benchmark.reference.train import edit_readings as readings  # noqa: F401
from benchmark.reference.train import sd_configs

GUIDANCE = True


def finish_setup(prog, traffic) -> None:
    """Steps until every view's pretrained render is cached, so that the
    window renders none for the first time."""
    left = traffic["views"] - prog.step
    if left > 0:
        prog.trainer.train_one_epoch(prog.take(left))


@contextlib.contextmanager
def stash(trainer):
    """``cot``: the SDS cotangent of the last call of the guidance's
    ``sds_grad`` meanwhile.  Under a captured step that call is the
    capture's, and the tensor it returned is the graph's own buffer, which
    each replay writes: it is held, not copied, so the graph runs the same
    kernels with the hold or without it."""
    guidance = trainer.guidance
    base = guidance.sds_grad
    held = {}

    def sds_grad(*args, **kwargs):
        grad, value = base(*args, **kwargs)
        held["cot"] = grad
        return grad, value

    guidance.sds_grad = sds_grad
    try:
        yield held
    finally:
        del guidance.sds_grad


def guidance_work(cfg) -> tuple:
    """The UNet's launches a step as (flops, bytes, peak), and the model
    FLOPs of the guidance: the UNet's forward at the CFG batch and the VAE
    encoder's forward and backward at 512²."""
    sdc = counts.sd_counts(*sd_configs(cfg))
    model = sdc["unet"][0] + sdc["vae_forward"][0] + sdc["vae_backward"][0]
    return {"unet": [(*sdc["unet"], counts.PEAK_BF16_FLOPS)]}, model
