"""``NeRFField`` of the port against the JAX package's flax field, with the
same parameters carried across by ``engine/convert.py``: σ, radiance and
``density`` against ``NeRFField.apply`` (f32 compute) and against
``make_pallas_apply`` with the Pallas kernel in interpret mode; and each
field variant (``--mlp_bias``, ``--detach_mask_from_field``,
``--mask_no_dir[_nodetach]``, ``--train_conf 0``), forward and gradient,
against the flax field of the same configuration.

Tolerance: the encode and the MLP heads in f32 summed in another order,
then trunc_exp/sigmoid: ≤ 1e-5 relative; gradients ≤ 1e-5 of each leaf's
largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.models import field as jfield
from customnerf_tpu.ops import fused_mlp_pallas as fmp
from customnerf_tpu.ops import triplane as jtri
from customnerf_torch.engine import convert
from customnerf_torch.models import field as tfield
from customnerf_torch.ops import triplane

RES, CH, BOUND = (8, 16), (4, 2), 2.0


def _jax_field():
    spec = jtri.TriplaneSpec(resolutions=RES, channels=CH, bwd="matmul",
                             mm_bf16=False, bwd_chunk=64)
    f = jfield.NeRFField(jfield.FieldConfig(bound=BOUND, grid=spec))
    params = f.init_params(jax.random.PRNGKey(0))
    # O(1)-scale table so the encode matters next to the blob
    rng = np.random.RandomState(3)
    tab = rng.randn(*params["params"]["grid_table"].shape).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, params)
    params["params"]["grid_table"] = tab * 0.5
    return f, params


def _torch_field(params):
    cfg = tfield.FieldConfig(bound=BOUND, grid=triplane.TriplaneSpec(RES, CH))
    f = tfield.NeRFField(cfg, seed=0, device="cpu")
    f.load_state_dict(convert.params_from_flax(params))
    return f


@pytest.fixture(scope="module")
def fields():
    jf, params = _jax_field()
    return jf, params, _torch_field(params)


def _inputs(n=257, seed=1):
    rng = np.random.RandomState(seed)
    x = ((rng.rand(n, 3) * 2 - 1) * BOUND * 1.05).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    return x, d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_convert_roundtrip_and_layout(fields):
    _, params, tf = fields
    back = convert.params_to_flax(tf.state_dict())
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # flax Dense.kernel [in, out] → nn.Linear.weight [out, in]; the rgb head
    # takes [view_en(27) ‖ fea(64)] in that order
    assert tf.rgb_net.hidden_0.weight.shape == (64, 27 + 64)
    np.testing.assert_array_equal(
        tf.rgb_net.hidden_0.weight[:, :27].detach().numpy(),
        params["params"]["rgb_net"]["hidden_0"]["kernel"][:27].T)


def test_field_matches_flax_apply(fields):
    jf, params, tf = fields
    x, d = _inputs()
    js, jr = jf.apply(params, jnp.asarray(x), jnp.asarray(d))
    jd = jf.apply(params, jnp.asarray(x), method=jf.density)
    with torch.no_grad():
        ts, tr = tf(torch.tensor(x), torch.tensor(d))
        td = tf.density(torch.tensor(x))
    assert tr.shape == (x.shape[0], 4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


def test_field_matches_pallas_apply(fields, monkeypatch):
    orig = fmp.pl.pallas_call

    def interp_call(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(fmp.pl, "pallas_call", interp_call)
    jf, params, tf = fields
    fused, density = jfield.make_pallas_apply(jf, params)
    x, d = _inputs(300, 2)
    js, jr = fused(jnp.asarray(x.reshape(3, 100, 3)),
                   jnp.asarray(d.reshape(3, 100, 3)))
    jd = density(jnp.asarray(x))
    with torch.no_grad():
        ts, tr = tf(torch.tensor(x.reshape(3, 100, 3)),
                    torch.tensor(d.reshape(3, 100, 3)))
        td = tf.density(torch.tensor(x))
    assert ts.shape == (3, 100) and tr.shape == (3, 100, 4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-6)


def test_field_parameter_groups(fields):
    tf = fields[2]
    groups = tfield.param_groups(tf)
    assert groups["grid"] == [tf.grid_table]
    assert len(groups["mlp"]) == 7


def test_seeded_init_is_reproducible():
    cfg = tfield.FieldConfig(bound=BOUND, grid=triplane.TriplaneSpec(RES, CH))
    a, b = (tfield.NeRFField(cfg, seed=5, device="cpu") for _ in range(2))
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    w = a.feature_net.hidden_0.weight.detach()
    # LeCun-normal scale (flax Dense default): std ≈ 1/sqrt(fan_in)
    assert 0.7 < float(w.std()) * np.sqrt(w.shape[1]) < 1.3


def test_init_is_flax_lecun_truncated_normal():
    """The heads start as flax's Dense default: a normal truncated to ±2σ
    with variance 1/fan_in, no mass piled at the edge.  (A normal *clipped*
    at ±2σ has 24 % more variance and 4.6 % of its weights on the edge;
    with it the bear fixture trained to 21 dB instead of 25.4 on the H100,
    PERF.md, Findings.)"""
    spec = jtri.TriplaneSpec(resolutions=(128, 512), channels=(16, 8))
    jf = jfield.NeRFField(jfield.FieldConfig(bound=BOUND, grid=spec))
    flax = jax.tree_util.tree_map(np.asarray, jf.init_params(jax.random.PRNGKey(0)))
    tf = tfield.NeRFField(tfield.FieldConfig(bound=BOUND, grid=triplane.TriplaneSpec(
        (128, 512), (16, 8))), seed=0, device="cpu")
    port = convert.params_to_flax(tf.state_dict())

    def pooled(tree):
        ks = [np.asarray(leaf) * np.sqrt(leaf.shape[0])
              for path, leaf in jax.tree_util.tree_leaves_with_path(tree)
              if "kernel" in jax.tree_util.keystr(path)]
        return np.concatenate([k.ravel() for k in ks])

    want, got = pooled(flax), pooled(port)
    assert got.size == want.size > 20000
    edge = 2.0 / 0.87962566103423978
    assert np.abs(got).max() <= edge * (1 + 1e-6)
    assert np.mean(np.abs(got) > 0.99 * edge) < 0.005
    assert np.std(got) == pytest.approx(np.std(want), rel=0.03)
    assert np.std(got) == pytest.approx(1.0, rel=0.03)
    # the two samples' distributions: Kolmogorov-Smirnov distance
    grid = np.linspace(-edge, edge, 201)
    cdf = lambda v: np.searchsorted(np.sort(v), grid) / v.size  # noqa: E731
    assert np.abs(cdf(got) - cdf(want)).max() < 0.02


@pytest.mark.parametrize("variant", ["use_bias", "detach_mask_from_field",
                                     "mask_no_dir"])
def test_unported_variants_raise(variant, monkeypatch):
    """The variants that once raised now build and run the plain PyTorch
    heads: the fused kernel covers the default head only, as the JAX
    package's ``make_pallas_apply`` does."""
    calls = []
    monkeypatch.setattr(tfield, "fused_field_mlp",
                        lambda *a, **k: calls.append(1))
    cfg = tfield.FieldConfig(grid=triplane.TriplaneSpec(RES, CH),
                             **{variant: True})
    f = tfield.NeRFField(cfg, device="cpu")
    x, d = _inputs(33, 5)
    with torch.no_grad():
        sigma, rad = f(torch.tensor(x), torch.tensor(d))
        f.density(torch.tensor(x))
    assert not f.fused and not calls
    assert sigma.shape == (33,) and rad.shape == (33, 4)
    assert (f.conf_net is not None) == (variant != "use_bias")


VARIANTS = {
    "mlp_bias": dict(use_bias=True),
    "detach_mask_from_field": dict(detach_mask_from_field=True),
    "mask_no_dir": dict(mask_no_dir=True),
    "mask_no_dir_nodetach": dict(mask_no_dir=True, mask_no_dir_nodetach=True),
    "train_conf_0": dict(train_conf=False),
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_field_variant_matches_flax(name):
    """Forward and gradient (of a random linear functional of σ and the
    radiance) against the flax field; the stop-gradients of the conf net's
    input show as equal gradients of the feature net and the table."""
    kw = VARIANTS[name]
    spec = jtri.TriplaneSpec(resolutions=RES, channels=CH, bwd="matmul",
                             mm_bf16=False, bwd_chunk=64)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=BOUND, grid=spec, **kw))
    params = jax.tree_util.tree_map(np.asarray, jf.init_params(jax.random.PRNGKey(1)))
    rng = np.random.RandomState(7)
    params = jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * (0.5 if a.ndim == 2 and a.shape[0] > 100
                                          else 0.3)).astype(np.float32)
        if a.ndim == 1 or a.shape[0] > 100 else a, params)
    tf = tfield.NeRFField(tfield.FieldConfig(bound=BOUND, grid=triplane.TriplaneSpec(RES, CH),
                                             **kw), device="cpu")
    tf.load_state_dict(convert.params_from_flax(params))
    assert not tf.fused
    x, d = _inputs(211, 6)
    n_rad = 3 if name == "train_conf_0" else 4
    a = rng.randn(211).astype(np.float32)
    b = rng.randn(211, n_rad).astype(np.float32)

    def jloss(p):
        s, r = jf.apply(p, jnp.asarray(x), jnp.asarray(d))
        return jnp.sum(s * a) + jnp.sum(r * b), (s, r)

    (_, (js, jr)), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    ts, tr = tf(torch.tensor(x), torch.tensor(d))
    assert tr.shape == (211, n_rad)
    np.testing.assert_allclose(ts.detach().numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.detach().numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6)
    ((ts * torch.tensor(a)).sum() + (tr * torch.tensor(b)).sum()).backward()
    tg = convert.params_to_flax({n: p.grad for n, p in tf.named_parameters()})
    jl = dict(jax.tree_util.tree_leaves_with_path(jg))
    tl = dict(jax.tree_util.tree_leaves_with_path(tg))
    assert jl.keys() == tl.keys()
    for path, g in jl.items():
        g = np.asarray(g)
        np.testing.assert_allclose(tl[path], g, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-6),
                                   err_msg=jax.tree_util.keystr(path))
    back = convert.params_to_flax(tf.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(dict(jax.tree_util.tree_leaves_with_path(back))[path], leaf)


def test_density_only_head_matches_pallas_density(fields, monkeypatch):
    """``NeRFField.density`` runs the fused head without its rgb part; the
    JAX ``make_pallas_apply`` density runs the full Pallas head (interpret
    mode) on zero directions.  Same converted parameters, same inputs."""
    orig = fmp.pl.pallas_call

    def interp_call(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    monkeypatch.setattr(fmp.pl, "pallas_call", interp_call)
    calls = []
    fused = tfield.fused_field_mlp

    def recording(*args, **kwargs):
        calls.append(kwargs.get("with_rgb", True))
        return fused(*args, **kwargs)

    monkeypatch.setattr(tfield, "fused_field_mlp", recording)
    jf, params, tf = fields
    _, density = jfield.make_pallas_apply(jf, params)
    x, _ = _inputs(333, 4)
    jd = density(jnp.asarray(x.reshape(9, 37, 3)))
    with torch.no_grad():
        td = tf.density(torch.tensor(x.reshape(9, 37, 3)))
    assert calls == [False]
    assert td.shape == (9, 37)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5, atol=1e-5)


def test_threefry_draws_equal_jax_random():
    """``utils/threefry.py`` against ``jax.random``: keys, folds, bits and
    uniforms bit for bit (the partitionable threefry layout)."""
    from customnerf_torch.utils import threefry
    for seed in (0, 1, 12345):
        key = jax.random.PRNGKey(seed)
        ours = threefry.prng_key(seed)
        np.testing.assert_array_equal(np.asarray(key), np.array(ours, np.uint32))
        for data in (1, 7, 2 ** 31 + 5):
            np.testing.assert_array_equal(np.asarray(jax.random.fold_in(key, data)),
                                          np.array(threefry.fold_in(ours, data), np.uint32))
        np.testing.assert_array_equal(np.asarray(jax.random.bits(key, (300_001,))),
                                      threefry.random_bits(ours, (300_001,)))
        for lo, hi in ((0.0, 1.0), (-1e-4, 1e-4), (-0.9545, 0.9545)):
            np.testing.assert_array_equal(
                np.asarray(jax.random.uniform(key, (301, 7), minval=lo, maxval=hi)),
                threefry.uniform(ours, (301, 7), lo, hi))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("kind,kw", [
    ("grid", {}), ("hash", {}), ("hash", {"detach_mask_from_field": True,
                                         "conf_channels": 2}),
    ("grid", {"mask_no_dir": True, "use_bias": True})],
    ids=["grid", "hash", "hash-detach-conf2", "grid-maskNoDir-bias"])
def test_init_equals_the_jax_package_init(seed, kind, kw):
    """A seed gives the grid field the JAX package's ``init_params(PRNGKey(
    seed))``: the table bit for bit, the kernels to the last bits of f32
    ``erfinv`` (XLA's and PyTorch's round differently: ≤ 1e-6 of each
    kernel's largest entry), zero biases.  The bear parity run's outcome
    depends on the initial draw (PERF.md)."""
    from customnerf_tpu.ops import grid as jgrid
    from customnerf_torch.ops import grid as tgrid
    g = dict(num_levels=4, level_dim=2, base_resolution=4, log2_hashmap_size=10,
             desired_resolution=64, gridtype=kind if kind == "hash" else "tiled")
    jspec, tspec = jgrid.GridSpec(**g), tgrid.GridSpec(**g)
    want = jax.tree_util.tree_map(np.asarray, jfield.NeRFField(
        jfield.FieldConfig(bound=BOUND, grid=jspec, **kw)).init_params(
            jax.random.PRNGKey(seed)))
    got = convert.params_to_flax(tfield.NeRFField(
        tfield.FieldConfig(bound=BOUND, grid=tspec, **kw), seed=seed,
        device="cpu").state_dict())
    w, t = (dict(jax.tree_util.tree_leaves_with_path(x)) for x in (want, got))
    assert w.keys() == t.keys()
    for path, a in w.items():
        name = jax.tree_util.keystr(path)
        if "grid_table" in name or "bias" in name:
            np.testing.assert_array_equal(t[path], a, err_msg=name)
        else:
            np.testing.assert_allclose(t[path], a, rtol=0,
                                       atol=1e-6 * np.abs(a).max(), err_msg=name)


@pytest.mark.parametrize("kw", [{}, {"detach_mask_from_field": True, "use_bias": True}],
                         ids=["fused", "detach-bias"])
def test_triplane_init_is_one_seeded_torch_generator(kw):
    """The tri-plane field draws from one ``torch.Generator`` seeded with
    the seed: the table (``triplane_init``), then each head's kernel in
    module and layer order from flax's truncated LeCun normal by inverting
    its CDF in f64 — the draw the flagship's quality gates were set on
    (PERF.md); biases start at zero."""
    import math
    spec = triplane.TriplaneSpec(RES, CH)
    tf = tfield.NeRFField(tfield.FieldConfig(bound=BOUND, grid=spec, **kw), seed=7,
                          device="cpu")
    gen = torch.Generator().manual_seed(7)
    assert torch.equal(tf.grid_table, triplane.triplane_init(spec, generator=gen))
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    mlps = [tf.feature_net, tf.density_net, tf.rgb_net, tf.conf_net]
    assert (tf.conf_net is not None) == bool(kw)
    for mod in (m for m in mlps if m is not None):
        for lin in mod.layers():
            u = lo + (1.0 - 2.0 * lo) * torch.rand(lin.weight.shape, generator=gen,
                                                   dtype=torch.float64)
            w = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
            want = (w * (lin.weight.shape[1] ** -0.5 / 0.87962566103423978)).float()
            assert torch.equal(lin.weight, want)
            assert lin.bias is None or not lin.bias.any()
