"""``NeRFField`` of the port against the JAX package's flax field, with the
same parameters carried across by ``engine/convert.py``: σ, radiance and
``density`` against ``NeRFField.apply`` (f32 compute) and against
``make_pallas_apply`` with the Pallas kernel in interpret mode.

Tolerance: the encode and the MLP heads in f32 summed in another order,
then trunc_exp/sigmoid: ≤ 1e-5 relative.
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


@pytest.mark.parametrize("variant", ["use_bias", "detach_mask_from_field",
                                     "mask_no_dir"])
def test_unported_variants_raise(variant):
    cfg = tfield.FieldConfig(grid=triplane.TriplaneSpec(RES, CH),
                             **{variant: True})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tfield.NeRFField(cfg, device="cpu")


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
