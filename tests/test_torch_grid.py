"""The port's multiresolution grid encoder (``ops/grid.py``) and the grid
family's small modules (``ops/morton.py``, ``ops/regularizers.py``) against
the JAX package's, on inputs made from a numpy seed.

Tolerance: 1e-5 of the largest output / gradient entry.  Both sides gather
the same eight corners with the same f32 weights; they differ only in the
order of the eight-term corner sum (XLA: a matmul with a 0/1 matrix) and of
the table gradient's scatter, a few ulp of O(1) sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.ops import grid as jgrid
from customnerf_tpu.ops import morton as jmorton
from customnerf_tpu.ops import regularizers as jreg
from customnerf_torch.engine import convert
from customnerf_torch.models import field as tfield
from customnerf_torch.ops import grid as tgrid
from customnerf_torch.ops import morton as tmorton
from customnerf_torch.ops import regularizers as treg
from customnerf_torch.utils import threefry

TOL = 1e-5
PARITY = dict(num_levels=16, level_dim=2, base_resolution=16,
              log2_hashmap_size=21, desired_resolution=8192, gridtype="tiled")
PARITY_SIZES = [4920, 17576, 54872, 185200, 636056] + [2097152] * 11


def _specs(gridtype, log2, levels=5, res=64, base=4):
    kw = dict(num_levels=levels, level_dim=2, base_resolution=base,
              log2_hashmap_size=log2, desired_resolution=res, gridtype=gridtype)
    return jgrid.GridSpec(**kw), tgrid.GridSpec(**kw)


def _points(spec, rng, n=600):
    """Uniform points, some outside [0, 1], the cube's corners and faces,
    and points on cell edges of every level (pos = x·scale + 0.5 an
    integer)."""
    x = rng.rand(n, 3).astype(np.float32) * 1.2 - 0.1
    edges = []
    for scale in spec.level_meta["scales"]:
        k = rng.randint(1, int(scale) + 1, size=(8, 3))
        edges.append(((k - 0.5) / scale).astype(np.float32))
    corners = np.array([[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0.25, 0]], np.float32)
    return np.concatenate([x, *edges, corners]).clip(-0.5, 1.5)


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale, err_msg=what)


def test_level_meta_of_the_parity_spec_equals_jax():
    j, t = jgrid.GridSpec(**PARITY), tgrid.GridSpec(**PARITY)
    assert set(j.level_meta) == set(t.level_meta)
    for k, v in j.level_meta.items():
        np.testing.assert_array_equal(t.level_meta[k], v, err_msg=k)
        assert t.level_meta[k].dtype == v.dtype, k
    assert t.level_meta["sizes"].tolist() == PARITY_SIZES
    assert t.table_size == j.table_size == 23_967_296 and t.output_dim == 32
    # tiled: levels 5-15 alias through the modulo, none hashes
    assert not t.level_meta["use_hash"].any()
    hashed = tgrid.GridSpec(**dict(PARITY, gridtype="hash"))
    assert hashed.level_meta["use_hash"].tolist() == [False] * 5 + [True] * 11
    assert tfield.PARITY_GRID == t and tfield.FieldConfig().grid == t


@pytest.mark.parametrize("max_level", [None, 3])
@pytest.mark.parametrize("gridtype,log2", [("tiled", 10), ("hash", 10),
                                           ("tiled", 12), ("hash", 12)])
def test_grid_encode_and_gradients_match_jax(gridtype, log2, max_level):
    js, ts = _specs(gridtype, log2)
    rng = np.random.RandomState(log2)
    x = _points(ts, rng)
    table = rng.randn(ts.table_size, 2).astype(np.float32)
    g = rng.randn(x.shape[0], ts.output_dim).astype(np.float32)

    def jloss(t, xx):
        return (jgrid.grid_encode(xx, t, js, max_level=max_level) * g).sum()

    jout = np.asarray(jgrid.grid_encode(jnp.asarray(x), jnp.asarray(table), js,
                                        max_level=max_level))
    jdt, jdx = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(table), jnp.asarray(x))

    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    out = tgrid.grid_encode(xt, tt, ts, max_level=max_level)
    (out * torch.tensor(g)).sum().backward()

    _close(out.detach().numpy(), jout, "output")
    _close(tt.grad.numpy(), np.asarray(jdt), "table gradient")
    _close(xt.grad.numpy(), np.asarray(jdx), "input gradient")
    outside = ((x < 0) | (x > 1)).any(-1)
    assert outside.sum() > 10 and not out.detach().numpy()[outside].any()
    assert not xt.grad.numpy()[outside].any()
    if max_level is not None:
        assert not out.detach().numpy()[:, max_level * 2:].any()


def test_grid_encode_of_the_parity_spec_on_a_few_points():
    """The 24 M-row table: the port's encode at the reference's spec agrees
    with JAX's on a few points (tiled levels 5-15 alias through % 2^21)."""
    js, ts = jgrid.GridSpec(**PARITY), tgrid.GridSpec(**PARITY)
    table = tfield.encoder_init(ts, threefry.prng_key(0))     # the field's draw
    assert table.shape == (23_967_296, 2)
    assert float(table.min()) >= -1e-4 and float(table.max()) <= 1e-4
    table.mul_(1e4)
    x = np.random.RandomState(1).rand(64, 3).astype(np.float32)
    want = np.asarray(jgrid.grid_encode(jnp.asarray(x), jnp.asarray(table.numpy()), js))
    got = tgrid.grid_encode(torch.tensor(x), table, ts).numpy()
    _close(got, want, "parity spec")
    # the flax-layout carry of the full table keeps every entry
    sd = {"grid_table": table}
    back = convert.params_from_flax(convert.params_to_flax(sd))["grid_table"]
    assert back.shape == (23_967_296, 2) and back.dtype == torch.float32
    assert torch.equal(back, table)


def _rays_points(rng, n_rays=256, n_samples=64):
    """Points along rays through the unit cube, consecutive samples of a
    ray next to each other (the layout of a step's fine pass)."""
    o = rng.rand(n_rays, 1, 3).astype(np.float32)
    d = rng.randn(n_rays, 1, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.linspace(0.0, 0.6, n_samples, dtype=np.float32)[None, :, None]
    return (o + t * d).reshape(-1, 3).astype(np.float32)


def _emulated_rows(packed, x, n_levels, shift):
    """The kernels' index arithmetic (``csrc/grid_encode.cu::corner_row``) in
    numpy uint32, from the packed level argument alone: [B, n_levels, 8]."""
    scale = packed[:, 0].view(np.float32)
    size, offset, strides, hashed = packed[:, 1], packed[:, 2], packed[:, 3:6], packed[:, 6]
    primes = [np.uint32(p) for p in tgrid.PRIMES]
    rows = np.empty((x.shape[0], n_levels, 8), dtype=np.int64)
    for lv in range(n_levels):
        pos = x * scale[lv] + np.float32(shift)                      # f32, rounded twice
        c0 = np.floor(pos).astype(np.int64).astype(np.uint32)
        for k in range(8):
            c = [c0[:, d] + np.uint32((k >> (2 - d)) & 1) for d in range(3)]
            if hashed[lv]:
                idx = (c[0] * primes[0]) ^ (c[1] * primes[1]) ^ (c[2] * primes[2])
            else:
                idx = c[0] * strides[lv, 0] + c[1] * strides[lv, 1] + c[2] * strides[lv, 2]
            rows[:, lv, k] = (idx % size[lv]).astype(np.int64) + int(offset[lv])
    return rows


@pytest.mark.parametrize("kind,max_level", [("tiled", None), ("hash", None), ("mixed", None),
                                            ("parity", None), ("mixed", 3), ("parity", 7)])
def test_kernel_level_argument_gives_the_plain_rows(kind, max_level, monkeypatch):
    """The kernels' packed per-level argument, decoded by a uint32 emulation
    of their index arithmetic, gives exactly the plain path's corner rows;
    CPU tensors take the plain path and launch nothing."""
    if kind == "parity":
        ts = tgrid.GridSpec(**PARITY)
    elif kind == "mixed":          # a hash spec whose coarse levels fit densely
        ts = _specs("hash", 12)[1]
        assert 0 < ts.level_meta["use_hash"].sum() < ts.num_levels
    else:
        ts = _specs(kind, 10)[1]
    n_levels = ts.num_levels if max_level is None else max_level
    rng = np.random.RandomState(len(kind) + n_levels)
    x = np.concatenate([_points(ts, rng), _rays_points(rng)])
    packed = tgrid.kernel_levels(ts, n_levels)
    assert packed.shape == (tgrid.KERNEL_LEVELS, tgrid.LEVEL_WORDS) and packed.dtype == np.uint32
    assert not packed[n_levels:].any()
    meta = ts.level_meta
    assert packed[:n_levels, 1].tolist() == meta["sizes"][:n_levels].tolist()
    assert packed[:n_levels, 6].tolist() == meta["use_hash"][:n_levels].astype(int).tolist()
    want, _, _ = tgrid._corners(torch.tensor(x), ts, n_levels)
    np.testing.assert_array_equal(_emulated_rows(packed, x, n_levels, 0.5), want.numpy())

    def no_library():
        raise AssertionError("a CPU tensor reached the kernels")

    monkeypatch.setattr(tgrid.kernels, "library", no_library)
    table = torch.zeros(ts.table_size, ts.level_dim, requires_grad=True)
    xt = torch.tensor(x[:512], requires_grad=True)
    tgrid.grid_encode(xt, table, ts, max_level=max_level).sum().backward()
    assert table.grad is not None and xt.grad is not None
    assert (tgrid.grid_encode.launches, tgrid.grid_encode.launches_bwd) == (0, 0)


@pytest.mark.parametrize("bad", ["level_dim", "input_dim", "levels", "dtype", "strided", "shape"])
def test_check_kernel_names_what_the_kernels_do_not_take(bad):
    """The wrapper's check, on CPU tensors: it accepts the parity spec's
    shapes and raises on each thing the kernels are not built for."""
    spec = tgrid.GridSpec(**dict(PARITY, log2_hashmap_size=10, desired_resolution=64))
    table = torch.zeros(spec.table_size, 2)
    x = torch.zeros(8, 3)
    tgrid.check_kernel(x, table, spec, spec.num_levels)
    n_levels = spec.num_levels
    if bad == "level_dim":
        spec = tgrid.GridSpec(**dict(PARITY, level_dim=3, log2_hashmap_size=10))
        table = torch.zeros(spec.table_size, 3)
    elif bad == "input_dim":
        spec = tgrid.GridSpec(**dict(PARITY, input_dim=2, log2_hashmap_size=10))
        table, x = torch.zeros(spec.table_size, 2), torch.zeros(8, 2)
    elif bad == "levels":
        spec = tgrid.GridSpec(**dict(PARITY, num_levels=17, log2_hashmap_size=10))
        table, n_levels = torch.zeros(spec.table_size, 2), 17
    elif bad == "dtype":
        table = table.to(torch.bfloat16)
    elif bad == "strided":
        table = torch.zeros(spec.table_size, 4)[:, :2]
    else:
        table = table[:-8]
    with pytest.raises((ValueError, TypeError), match="grid_encode"):
        tgrid.check_kernel(x, table, spec, n_levels)


def test_morton_round_trip_and_codes_match_jax():
    rng = np.random.RandomState(0)
    coords = rng.randint(0, 1024, size=(4096, 3)).astype(np.int32)
    coords[:3] = [[0, 0, 0], [1023, 1023, 1023], [1, 2, 3]]
    jcodes = np.asarray(jmorton.morton3D(jnp.asarray(coords)))
    tcodes = tmorton.morton3D(torch.tensor(coords))
    np.testing.assert_array_equal(tcodes.numpy(), jcodes.astype(np.int64))
    back = tmorton.morton3D_invert(tcodes)
    np.testing.assert_array_equal(back.numpy(), coords)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jmorton.morton3D_invert(jnp.asarray(jcodes))))


def test_sph_from_ray_matches_jax():
    rng = np.random.RandomState(1)
    o = (rng.rand(256, 3).astype(np.float32) - 0.5)
    d = rng.randn(256, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jmorton.sph_from_ray(jnp.asarray(o), jnp.asarray(d), 2.0))
    got = tmorton.sph_from_ray(torch.tensor(o), torch.tensor(d), 2.0).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 2.0, rtol=1e-5)


@pytest.mark.parametrize("gridtype", ["tiled", "hash"])
def test_total_variation_and_its_gradient_match_jax(gridtype, monkeypatch):
    js, ts = _specs(gridtype, 10)
    rng = np.random.RandomState(2)
    table = rng.randn(ts.table_size, 2).astype(np.float32)
    x = (rng.rand(512, 3).astype(np.float32) * 2 - 1) * 1.5
    # hand the JAX loss the same sample points its key would draw
    monkeypatch.setattr(jreg.jax.random, "uniform",
                        lambda key, shape, minval, maxval: jnp.asarray(x))
    jtv, jg = jax.value_and_grad(
        lambda t: jreg.grid_total_variation(t, js, jax.random.PRNGKey(0),
                                            n_samples=512, bound=1.5))(jnp.asarray(table))
    tt = torch.tensor(table, requires_grad=True)
    ttv = treg.grid_total_variation(tt, ts, x=torch.tensor(x), bound=1.5)
    ttv.backward()
    assert float(ttv.detach()) == pytest.approx(float(jtv), rel=1e-5)
    _close(tt.grad.numpy(), np.asarray(jg), "TV gradient")
    # the generator draws points when none are given
    gen = torch.Generator().manual_seed(0)
    assert float(treg.grid_total_variation(tt, ts, generator=gen, n_samples=64)) > 0
