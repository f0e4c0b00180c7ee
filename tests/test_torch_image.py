"""``customnerf_torch/utils/image.py`` against ``customnerf_tpu/utils/image.py``:
``srgb_to_linear`` and ``linear_to_srgb`` on the same inputs (both branches
and the threshold, negatives, above 1; f32, to 1e-6 relative: the powers'
rounding), and ``export_density_to_ply`` byte for byte, through the
marching-cubes branch (a stand-in ``skimage.measure.marching_cubes`` that
both sides import) and through the point-cloud branch (no scikit-image)."""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.utils import image as jimage
from customnerf_torch.utils import image as timage


def _inputs():
    rs = np.random.RandomState(0)
    x = rs.uniform(-0.1, 1.2, 4096).astype(np.float32)
    edges = np.array([0.0, 0.0031308, 0.04045, 1e-9, 1.0, 0.5, -0.01], np.float32)
    return np.concatenate([x, edges])


@pytest.mark.parametrize("fn", ["srgb_to_linear", "linear_to_srgb"])
def test_srgb_conversions_equal_the_jax_functions(fn):
    x = _inputs()
    want = np.asarray(getattr(jimage, fn)(jnp.asarray(x)))
    got = getattr(timage, fn)(torch.tensor(x))
    assert got.dtype == torch.float32 and got.shape == (len(x),)
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got.numpy()), ~ok)
    np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=1e-6, atol=1e-7)
    # numpy in, a tensor out
    np.testing.assert_array_equal(getattr(timage, fn)(x).numpy(), got.numpy())


def _fake_skimage(monkeypatch):
    def marching_cubes(grid, level, spacing):
        idx = np.argwhere(grid > level)[:7].astype(np.float64) * np.asarray(spacing)
        faces = np.arange(len(idx) // 3 * 3).reshape(-1, 3)
        return idx + 0.25, faces, None, None

    measure = types.ModuleType("skimage.measure")
    measure.marching_cubes = marching_cubes
    pkg = types.ModuleType("skimage")
    pkg.measure = measure
    monkeypatch.setitem(sys.modules, "skimage", pkg)
    monkeypatch.setitem(sys.modules, "skimage.measure", measure)


@pytest.mark.parametrize("branch", ["point_cloud", "marching_cubes"])
def test_export_density_to_ply_equals_the_jax_file(tmp_path, monkeypatch, branch):
    if branch == "marching_cubes":
        _fake_skimage(monkeypatch)
    else:
        monkeypatch.setitem(sys.modules, "skimage", None)
        monkeypatch.setitem(sys.modules, "skimage.measure", None)
    rs = np.random.RandomState(1)
    grid = rs.rand(6, 5, 4).astype(np.float32) * 10
    origin, size = (-1.0, -0.5, 0.25), (0.1, 0.2, 0.3)
    a, b = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    assert jimage.export_density_to_ply(grid, origin, size, a, level=5.0) == a
    assert timage.export_density_to_ply(grid, origin, size, b, level=5.0) == b
    want = open(a, "rb").read()
    assert open(b, "rb").read() == want
    assert (b"element face" in want) == (branch == "marching_cubes")
