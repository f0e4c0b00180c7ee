"""Faults planted in the port's FLUX guidance, for the limits of the
``triplane-flux.edit_flux`` cell: each must leave the cell's ``correct``
false.

    python -m tools.flux_faults --fault NAME [--fault NAME ...] -- \\
        --workload triplane-flux.edit_flux --seeds N [N ...]

Run from the repository root on the card: for each ``--fault``, the
arguments after ``--`` go to ``benchmark.calibrate`` with the fault planted
(its rows are marked ``"side": "fault:<name>"``).  The faults of the
harness itself (``half_batch``, ``sds_scaled``, …) are ``calibrate``'s own
``--fault``; these are FLUX's:

* ``guidance_zeroed``: the guidance embedding ``guidance_in`` gives zeros;
* ``rope_dropped``: q and k attend unrotated;
* ``single_block_skipped``: the middle single-stream block is left out;
* ``qk_norm_dropped``: q and k skip their RMSNorm;
* ``sigma_unshifted``: σ = t/1000, without the resolution shift;
* ``transformer_fp8``: every linear of the transformer takes its operands
  rounded to fp8 e4m3 (one scale a tensor).

Each is planted through the guidance's construction (the cell builds its
guidance in its first step) or the module function it names, and taken
out on leaving :func:`planted`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys

import torch
import torch.nn.functional as F


def _zero_guidance(g):
    emb = g.unet.guidance_in
    emb.forward = lambda x: torch.zeros(x.shape[0], emb.out_layer.out_features,
                                        dtype=x.dtype, device=x.device)


def _skip_single_block(g):
    blocks = g.unet.single_blocks
    del blocks[len(blocks) // 2]


def _fp8_linears(g):
    from benchmark.reference.sd import fp8_round
    from customnerf_torch.guidance.layers import Linear
    for m in g.unet.modules():
        if isinstance(m, Linear):
            m.forward = (lambda x, m=m: F.linear(
                fp8_round(x), fp8_round(m.weight.to(x.dtype)),
                None if m.bias is None else m.bias.to(x.dtype)))


# faults planted on a built guidance
ON_GUIDANCE = {"guidance_zeroed": _zero_guidance, "single_block_skipped": _skip_single_block,
               "transformer_fp8": _fp8_linears}
# faults that replace a module function: (module, name, replacement)
ON_MODULE = {
    "rope_dropped": ("customnerf_torch.guidance.flux", "apply_rope", lambda x, table: x),
    "qk_norm_dropped": ("customnerf_torch.guidance.flux", "RMSNorm.forward", lambda self, x: x),
    "sigma_unshifted": ("customnerf_torch.guidance.sds", "flow_sigma",
                        lambda t, tokens: t.float() / 1000.0),
}
NAMES = tuple(ON_GUIDANCE) + tuple(ON_MODULE)


@contextlib.contextmanager
def planted(name: str):
    """The fault ``name`` planted in the port meanwhile."""
    import importlib

    from customnerf_torch.guidance import sds
    if name in ON_GUIDANCE:
        owner, attr = sds.StableDiffusionGuidance, "__init__"
        base = owner.__init__

        def new(self, *args, **kwargs):
            base(self, *args, **kwargs)
            ON_GUIDANCE[name](self)
    elif name in ON_MODULE:
        module, path, new = ON_MODULE[name]
        owner = importlib.import_module(module)
        *outer, attr = path.split(".")
        for part in outer:
            owner = getattr(owner, part)
    else:
        raise ValueError(f"unknown fault {name!r}: one of {NAMES}")
    held = getattr(owner, attr)
    setattr(owner, attr, new)
    try:
        yield
    finally:
        setattr(owner, attr, held)


@contextlib.contextmanager
def _marked(calibrate, side: str):
    """``calibrate``'s JSON rows with their ``side`` set to ``side``."""
    def marked(*args, **kwargs):
        if args and isinstance(args[0], str) and args[0].startswith("{"):
            args = (json.dumps(dict(json.loads(args[0]), side=side)),) + args[1:]
        print(*args, **kwargs)
    calibrate.print = marked
    try:
        yield
    finally:
        del calibrate.print


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    split = argv.index("--") if "--" in argv else len(argv)
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fault", action="append", required=True, choices=NAMES)
    args = p.parse_args(argv[:split])
    from benchmark import calibrate
    rc = 0
    for name in args.fault:
        with planted(name), _marked(calibrate, f"fault:{name}"):
            rc |= calibrate.main(argv[split + 1:] + ["--program"])
    return rc


if __name__ == "__main__":
    sys.exit(main())
