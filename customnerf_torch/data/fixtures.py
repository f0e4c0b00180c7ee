"""Write the repo's bear-class test scenes without ``cv2``.

``scripts/make_bear_fixture.py`` (nerfstudio) and
``scripts/make_llff_dtu_fixtures.py`` (LLFF, DTU) render the scenes and
write them with ``cv2.imwrite`` / ``cv2.cvtColor``.  The functions here run
those scripts' own code, imported by path, with a stand-in ``cv2`` in
``sys.modules`` that writes through ``utils/png.py``; the stand-in lives only
for the duration of the call, and whatever ``cv2`` was there before (or its
absence) is restored before they return.

    python -m customnerf_torch.data.fixtures OUT_ROOT [--data_type T ...]

writes ``OUT_ROOT/bear`` (nerfstudio), ``OUT_ROOT/llff`` and ``OUT_ROOT/dtu``
(or those of the formats named) at the scripts' default sizes.  ``--jpeg``
adds, beside each nerfstudio or LLFF fixture, its copy in the reference
layout (``bear_jpeg/``, ``llff_jpeg/``): images ``.jpg`` through
``utils/jpeg.py::write_jpeg`` at quality 95, masks still ``.png``.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import importlib.util
import json
import os
import shutil
import sys
import types

from customnerf_torch.utils import jpeg, png

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "scripts")
SWAP_RB = 4                # cv2's code for both COLOR_BGR2RGB and COLOR_RGB2BGR


def _stand_in() -> types.ModuleType:
    cv2 = types.ModuleType("cv2")
    cv2.COLOR_BGR2RGB = cv2.COLOR_RGB2BGR = SWAP_RB

    def cvtColor(img, code):
        assert code == SWAP_RB, code
        return img[..., ::-1].copy()

    def imwrite(path, img):
        png.write(path, img if img.ndim == 2 else img[..., ::-1])
        return True

    cv2.cvtColor, cv2.imwrite = cvtColor, imwrite
    return cv2


@contextlib.contextmanager
def stand_in_cv2():
    """``cv2`` in ``sys.modules`` is the PNG stand-in inside the block."""
    missing = object()
    before = sys.modules.get("cv2", missing)
    sys.modules["cv2"] = _stand_in()
    try:
        yield
    finally:
        if before is missing:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = before


def _script(name: str):
    """Import ``scripts/{name}.py`` by path (once)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(SCRIPTS, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        path = list(sys.path)
        try:
            spec.loader.exec_module(mod)
        finally:
            sys.path[:] = path
    return sys.modules[name]


def write_bear(out: str, n_views: int = 28, W: int = 400, H: int = 300) -> str:
    """The nerfstudio fixture (``transforms.json``, ``images/``,
    ``lang_bear/``) of ``scripts/make_bear_fixture.py``."""
    mod = _script("make_bear_fixture")
    argv = sys.argv
    sys.argv = [mod.__file__, out, str(n_views), str(W), str(H)]
    try:
        with stand_in_cv2():
            mod.main()
    finally:
        sys.argv = argv
    return out


def write_llff(out: str, n_views: int = 24, W: int = 400, H: int = 300) -> str:
    _script("make_bear_fixture")
    with stand_in_cv2():
        _script("make_llff_dtu_fixtures").make_llff(out, n_views, W, H)
    return out


def write_dtu(out: str, n_views: int = 24, W: int = 400, H: int = 300) -> str:
    _script("make_bear_fixture")
    with stand_in_cv2():
        _script("make_llff_dtu_fixtures").make_dtu(out, n_views, W, H)
    return out


WRITERS = {"nerfstudio": ("bear", write_bear, 28),
           "llff": ("llff", write_llff, 24),
           "dtu": ("dtu", write_dtu, 24)}


def write(data_type: str, root: str, n_views: int = 0, W: int = 400,
          H: int = 300) -> str:
    """The fixture of ``data_type`` under ``root``; ``n_views`` 0 = the
    scripts' defaults (28 views for the bear, 24 for LLFF and DTU)."""
    sub, fn, default_views = WRITERS[data_type]
    return fn(os.path.join(root, sub), n_views or default_views, W, H)


def jpeg_copy(src: str, dst: str, quality: int = 95) -> str:
    """A copy of a nerfstudio or LLFF fixture in the reference layout: each
    ``images/*.png`` encoded as ``.jpg`` (``transforms.json``'s paths
    follow), the masks and the rest copied as they are."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("images"))
    os.makedirs(os.path.join(dst, "images"))
    for p in sorted(glob.glob(os.path.join(src, "images", "*.png"))):
        name = os.path.splitext(os.path.basename(p))[0] + ".jpg"
        jpeg.write_jpeg(os.path.join(dst, "images", name), png.read_rgb(p), quality)
    meta = os.path.join(dst, "transforms.json")
    if os.path.exists(meta):
        with open(meta) as f:
            m = json.load(f)
        for fr in m["frames"]:
            fr["file_path"] = os.path.splitext(fr["file_path"])[0] + ".jpg"
        with open(meta, "w") as f:
            json.dump(m, f, indent=2)
    return dst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("root")
    ap.add_argument("--data_type", nargs="+", choices=sorted(WRITERS),
                    default=list(WRITERS))
    ap.add_argument("--jpeg", action="store_true")
    args = ap.parse_args(argv)
    for data_type in args.data_type:
        out = write(data_type, args.root)
        if args.jpeg and data_type in ("nerfstudio", "llff"):
            jpeg_copy(out, out + "_jpeg")


if __name__ == "__main__":
    main()
