"""Reconstruction, ``bear.sh`` phase 1: the port's ``Trainer`` from the
field's initial draw, each step one view's rays, K steps a dispatch through
``Trainer.train_many``."""

from __future__ import annotations

import contextlib

from benchmark.reference.train import recon_readings as readings  # noqa: F401

GUIDANCE = False


def finish_setup(prog, traffic) -> None:
    """Nothing beyond the checked steps."""


def stash(trainer):
    """A reconstruction step hands over nothing besides Adam's state."""
    return contextlib.nullcontext({})


def guidance_work(cfg) -> tuple:
    return {}, 0.0
