"""The JAX package's bf16 policy in the port, against the JAX package on the
CPU at small widths: the flax bf16 field heads (the fused head's bf16 mode
and the variant heads), dT's bf16 operands (``mm_bf16``) against the XLA
twin and both Pallas kernels in interpret mode, the tri-plane encode under
``--triplane_fwd_bf16``, one ``-O`` and one ``-O2`` trainer step under bf16
heads, the SD UNet and VAE in bf16, one SDS gradient, one Custom Diffusion
tuning step on the bf16 stack, and which head, dT mode and SD dtype each
flag set selects.

Both sides round the same values to bf16 at the same places; what differs
is the order of the f32 sums, so a value near a rounding boundary may land
one bf16 ulp (2^-8 relative) apart and carry that through the layers after
it.  Tolerances: the heads' σ and radiance to 1e-2 of the largest output
(a 1-ulp flip in a logit, through exp or a sigmoid); dT and the encode to
1e-5 of the largest value (the same roundings, f32 sums in another order);
a trainer step's loss to 1e-2 relative and each gradient leaf to 3e-2 of its
largest entry; UNet ε, the VAE's mean and the SDS gradient to 3e-2 of the
largest entry (tens of bf16 layers); the tuning loss to 1e-2 relative and
the adapter and token-row gradients to 5e-2 of their largest entry.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu import config as jconfig
from customnerf_tpu.engine import trainer as jtrainer
from customnerf_tpu.guidance import custom_diffusion as jcd
from customnerf_tpu.guidance import scheduler as jsched
from customnerf_tpu.guidance.sds import StableDiffusionGuidance as JGuidance
from customnerf_tpu.guidance.unet import UNet2DCondition as JUNet, UNetConfig as JUNetConfig
from customnerf_tpu.guidance.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from customnerf_tpu.models import field as jfield
from customnerf_tpu.models import renderer as jren
from customnerf_tpu.ops import occupancy as jocc
from customnerf_tpu.ops import triplane as jtri
from customnerf_tpu.ops.triplane_pallas import (plane_dtable_pallas,
                                                plane_dtable_pallas_fw)
from customnerf_torch import config as tconfig
from customnerf_torch.data.base import RayBatch
from customnerf_torch.engine import convert
from customnerf_torch.engine import trainer as ttrainer
from customnerf_torch.engine.convert import state_from_flax
from customnerf_torch.guidance import custom_diffusion as cd
from customnerf_torch.guidance.sds import StableDiffusionGuidance, sd_dtype
from customnerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from customnerf_torch.guidance.vae import AutoencoderKL, VAEConfig
from customnerf_torch.models import field as tfield
from customnerf_torch.models import renderer as tren
from customnerf_torch.ops import fused_mlp, occupancy as tocc
from customnerf_torch.ops import triplane, triplane_kernels

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guidance import (CTX, UNET_TINY, VAE_TINY, nchw, one_thread,  # noqa: E402,F401
                                 random_params)

RES, CH, BOUND = (8, 16), (4, 2), 2.0
BF16 = jnp.bfloat16


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _to_bf16(tree):
    """The JAX guidance's storage cast (``sds.py:120-128``)."""
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x).astype(BF16) if np.asarray(x).dtype == np.float32
        else jnp.asarray(x), tree)


def _close(got, want, share):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=share * scale)


# ------------------------------------------------------------------ heads
HEADS = {
    "fused": {},
    "mlp_bias": dict(use_bias=True),
    "detach_mask_from_field": dict(detach_mask_from_field=True),
    "mask_no_dir": dict(mask_no_dir=True),
    "mask_no_dir_nodetach": dict(mask_no_dir=True, mask_no_dir_nodetach=True),
    "train_conf_0": dict(train_conf=False),
}


@pytest.mark.parametrize("name", sorted(HEADS))
def test_bf16_heads_match_flax(name):
    """σ, radiance and ``density`` of the port's bf16 heads (the fused head's
    bf16 mode, on the CPU its plain version; the variants' plain heads)
    against the flax field with ``compute_dtype="bfloat16"``."""
    kw = HEADS[name]
    spec = jtri.TriplaneSpec(resolutions=RES, channels=CH, bwd="matmul", bwd_chunk=64)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=BOUND, grid=spec,
                                             compute_dtype="bfloat16", **kw))
    params = jax.tree_util.tree_map(np.asarray, jf.init_params(jax.random.PRNGKey(2)))
    rng = np.random.RandomState(4)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.5).astype(np.float32)
    tf = tfield.NeRFField(tfield.FieldConfig(
        bound=BOUND, grid=triplane.TriplaneSpec(RES, CH), compute_dtype="bfloat16", **kw),
        device="cpu")
    tf.load_state_dict(convert.params_from_flax(params))
    assert tf.fused == (name == "fused") and tf.fused_bf16
    x = ((rng.rand(301, 3) * 2 - 1) * BOUND).astype(np.float32)
    d = rng.randn(301, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    p = jax.tree_util.tree_map(jnp.asarray, params)
    js, jr = jf.apply(p, jnp.asarray(x), jnp.asarray(d))
    jd = jf.apply(p, jnp.asarray(x), method=jf.density)
    with torch.no_grad():
        ts, tr = tf(torch.tensor(x), torch.tensor(d))
        td = tf.density(torch.tensor(x))
    assert ts.dtype == tr.dtype == td.dtype == torch.float32
    _close(ts, js, 1e-2)
    _close(tr, jr, 1e-2)
    _close(td, jd, 1e-2)


def test_plain_bf16_head_is_flax_dense_rounding(monkeypatch):
    """``reference_forward(dtype=bf16)`` rounds every Dense output: its
    outputs are bf16 values, and differ from the f32 head's."""
    rng = np.random.RandomState(0)
    ws = [torch.tensor((rng.randn(*s) / np.sqrt(s[0])).astype(np.float32))
          for s in ((72, 64), (64, 64), (64, 64), (64, 64), (64, 1), (91, 64), (64, 4))]
    x = torch.tensor(rng.randn(50, 72).astype(np.float32))
    v = torch.tensor(rng.randn(50, 27).astype(np.float32))
    s16, r16 = fused_mlp.reference_forward(x, v, ws, dtype=torch.bfloat16)
    s32, r32 = fused_mlp.reference_forward(x, v, ws)
    for a in (s16, r16):
        assert a.dtype == torch.float32 and torch.equal(a, a.to(torch.bfloat16).float())
    assert not torch.equal(s16, s32) and float((r16 - r32).abs().max()) < 0.1

    def no_library():
        raise AssertionError("a CPU tensor reached the kernel")

    # the wrapper on CPU tensors is the plain version, not a launch
    monkeypatch.setattr(fused_mlp.kernels, "library", no_library)
    s, r = fused_mlp.fused_mlp_forward(x, v, ws, bf16=True)
    assert torch.equal(s, s16) and torch.equal(r, r16)


# -------------------------------------------------------------------- dT
def _dtable_inputs(R, C, B, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, R - 1, B).astype(np.int32),
            rng.randint(0, R - 1, B).astype(np.int32),
            rng.rand(B).astype(np.float32), rng.rand(B).astype(np.float32),
            rng.randn(B, C).astype(np.float32))


@pytest.mark.parametrize("R,C,B", [(16, 4, 300), (512, 8, 2000)], ids=["R16", "R512"])
@pytest.mark.parametrize("ref", ["xla", "pallas"])
def test_dtable_bf16_matches_jax(R, C, B, ref):
    """The plain bf16 mode against ``_plane_dtable(use_bf16=True)`` (what the
    JAX backward runs, ``_encode_mm_bwd``) and ``plane_dtable_pallas`` with
    ``use_bf16=True`` in interpret mode."""
    u0, v0, fu, fv, g = _dtable_inputs(R, C, B, R + C)
    args = tuple(map(jnp.asarray, (u0, v0, fu, fv, g)))
    if ref == "xla":
        want = jtri._plane_dtable(*args, R, C, chunk=128, use_bf16=True)
    else:
        want = plane_dtable_pallas(*args, R, C, chunk=128, use_bf16=True, interpret=True)
    want = np.asarray(want)
    got = triplane_kernels.plane_dtable(*map(torch.tensor, (u0, v0, fu, fv, g)), R, C,
                                        bf16=True).numpy()
    _close(got, want, 1e-5)
    # the f32 mode is another function: the bf16 rounding shows
    f32 = triplane_kernels.plane_dtable(*map(torch.tensor, (u0, v0, fu, fv, g)), R, C)
    assert np.abs(f32.numpy() - want).max() > 1e-5 * np.abs(want).max()


def test_dtable_fw_kernel_rounds_its_inputs_too():
    """``_dtable_kernel_fw`` in bf16 (``triplane_pallas.py:175-190``) rounds
    fu, fv and g themselves and forms 1 − fu and g·(1 − fv) in bf16
    arithmetic: another function than ``_plane_dtable``'s, which the port
    follows.  The two stay within their bf16 roundings (a few ulps of
    2^-8): 2e-2 of the largest texel."""
    R, C = 16, 4
    u0, v0, fu, fv, g = _dtable_inputs(R, C, 300, R + C)
    args = tuple(map(jnp.asarray, (u0, v0, fu, fv, g)))
    fw = np.asarray(plane_dtable_pallas_fw(*args, R, C, chunk=128, use_bf16=True,
                                           interpret=True))
    xla = np.asarray(jtri._plane_dtable(*args, R, C, chunk=128, use_bf16=True))
    got = triplane_kernels.plane_dtable(*map(torch.tensor, (u0, v0, fu, fv, g)), R, C,
                                        bf16=True).numpy()
    _close(got, fw, 2e-2)
    assert np.abs(fw - xla).max() > 1e-5 * np.abs(xla).max()


@pytest.mark.parametrize("mm_bf16", [True, False], ids=["mm_bf16", "mm_f32"])
def test_encode_fwd_bf16_matches_jax(mm_bf16):
    """``--triplane_fwd_bf16``: the encode's output, table gradient and input
    gradient against the JAX ``encode_positions`` with ``fwd_bf16=True``."""
    jspec = jtri.TriplaneSpec(resolutions=RES, channels=CH, bwd="matmul", bwd_chunk=64,
                              fwd_bf16=True, mm_bf16=mm_bf16)
    tspec = triplane.TriplaneSpec(RES, CH, fwd_bf16=True, mm_bf16=mm_bf16)
    rng = np.random.RandomState(3)
    x = rng.rand(400, 3).astype(np.float32)
    x[-2:] = [[1.2, 0.5, 0.5], [0.5, -0.1, 0.5]]            # out of range
    table = (rng.randn(tspec.table_size, tspec.max_channels) * 0.7).astype(np.float32)
    g = rng.randn(400, tspec.output_dim).astype(np.float32)

    def jloss(xx, tt):
        out = jfield.encode_positions(xx, tt, jspec)
        return jnp.sum(out * g), out

    (_, jout), (jdx, jdt) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(table))
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    out = tfield.encode_positions(xt, tt, tspec)
    (out * torch.tensor(g)).sum().backward()
    _close(out.detach(), jout, 1e-5)
    _close(tt.grad, jdt, 1e-5)
    _close(xt.grad, jdx, 1e-5)
    # the rows really were rounded
    plain = triplane.triplane_encode(torch.tensor(x), torch.tensor(table),
                                     dataclasses.replace(tspec, fwd_bf16=False))
    assert not torch.equal(plain, out.detach())


# ------------------------------------------------------------ trainer steps
def _o_step():
    """One -O step (occupancy march, compaction, tri-plane) from both
    packages' own field rules: bf16 heads, bf16 dT."""
    from test_torch_trainer import FLAGS, G, _batch
    jopt, topt = jconfig.parse_args(FLAGS), tconfig.parse_args(FLAGS)
    jf = jtrainer.build_field(jopt)
    field = ttrainer.build_field(topt, device="cpu")
    assert jf.cfg.compute_dtype == "bfloat16" and jf.cfg.grid.mm_bf16
    assert field.fused_bf16 and field.cfg.grid.mm_bf16
    params = convert.params_to_flax(field.state_dict())
    rng = np.random.RandomState(0)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.3).astype(np.float32)
    field.load_state_dict(convert.params_from_flax(params))
    dens = (rng.rand(2, G ** 3) < 0.5).astype(np.float32) * 50.0
    jocc_state = jocc.state_from_grid(dens, 1.0, density_thresh=10.0, grid_size=G)
    o, d, rgb, mask = _batch(1024, 1)
    s = jren.RenderSettings(bound=2.0, num_steps=16, upsample_steps=0, soft_mask=True)

    def loss_fn(p):
        out = jren.render_rays_fast(
            jf, p, jnp.asarray(o), jnp.asarray(d), jocc_state,
            jax.random.PRNGKey(0), s, n_coarse=32, n_keep=16, train=True,
            perturb=False, compact_frac=0.5, compact_block=8)
        return (jopt.train_rgb * jnp.mean((out["image"] - rgb) ** 2)
                + jopt.train_conf * jnp.mean((out["render_mask"][..., 0] - mask) ** 2))

    tt = ttrainer.Trainer(topt, field=field, device="cpu", log=lambda *_: None)
    tt.occ_state = tocc.state_from_grid(torch.tensor(dens), 1.0, 10.0, grid_size=G)
    batch = RayBatch(rgbs=torch.tensor(rgb), mask=torch.tensor(mask),
                     rays_o=torch.tensor(o), rays_d=torch.tensor(d), H=32, W=32,
                     img_path="parity", index=0)
    return loss_fn, params, tt, batch


def _o2_step(monkeypatch):
    """One -O2 step (the dense two-pass path on the tiled grid), the JAX
    pdf draws handed over."""
    from test_torch_dense import FLAGS, T, UP, _rays
    jopt, topt = jconfig.parse_args(FLAGS), tconfig.parse_args(FLAGS)
    jf = jtrainer.build_field(jopt)
    field = ttrainer.build_field(topt, device="cpu")
    assert jf.cfg.compute_dtype == "bfloat16" and field.fused_bf16
    params = convert.params_to_flax(field.state_dict())
    rng = np.random.RandomState(0)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.3).astype(np.float32)
    field.load_state_dict(convert.params_from_flax(params))
    n = 512
    o, d = _rays(n, 1)
    rgb = rng.rand(n, 3).astype(np.float32)
    mask = (rng.rand(n) < 0.4).astype(np.float32)
    s = jren.RenderSettings(bound=2.0, num_steps=T, upsample_steps=UP, soft_mask=True)
    key = jax.random.PRNGKey(0)

    def loss_fn(p):
        out = jren.render_rays(jf, p, jnp.asarray(o), jnp.asarray(d), key, s,
                               train=True, perturb=False)
        return (jopt.train_rgb * jnp.mean((out["image"] - rgb) ** 2)
                + jopt.train_conf * jnp.mean((out["render_mask"][..., 0] - mask) ** 2))

    u = torch.tensor(np.asarray(jax.random.uniform(jax.random.split(key)[1], (n, UP))))
    real = tren.sample_pdf

    def pdf(*a, **kw):
        # the renderer keeps f32 around the bf16 heads
        assert all(t.dtype == torch.float32 for t in a if torch.is_tensor(t))
        return real(*a, **dict(kw, u=u))

    monkeypatch.setattr(tren, "sample_pdf", pdf)
    tt = ttrainer.Trainer(topt, field=field, device="cpu", log=lambda *_: None)
    batch = RayBatch(rgbs=torch.tensor(rgb), mask=torch.tensor(mask),
                     rays_o=torch.tensor(o), rays_d=torch.tensor(d), H=16, W=32,
                     img_path="parity", index=0)
    return loss_fn, params, tt, batch


@pytest.mark.parametrize("path", ["O", "O2"])
def test_trainer_step_under_bf16_heads_matches_jax(monkeypatch, path):
    """The loss and every gradient leaf before Adam of one reconstruction
    step, both packages on their default precision for the flags.  The
    colour logits are spread (rgb_net's colour columns ×4), as a trained
    field's are: at the flax init every sample's colour sits within a few
    bf16 ulps of 0.5, the density gradient's colour differences along a ray
    are then of the order of one ulp, and on ``-O2`` the JAX package's own
    density gradient moves by 4-7 % when only its sigmoid's rounding
    changes."""
    loss_fn, params, tt, batch = _o_step() if path == "O" else _o2_step(monkeypatch)
    params["params"]["rgb_net"]["out"]["kernel"][:, :3] *= 4.0
    tt.field.load_state_dict(convert.params_from_flax(params))
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(
        jax.tree_util.tree_map(jnp.asarray, params))
    grads = {}
    apply = tt.apply_gradients

    def capture(loss, **kw):
        out = apply(loss, **kw)
        grads.update({n: p.grad.clone() for n, p in tt.field.named_parameters()})
        return out

    tt.apply_gradients = capture
    tloss, _, _ = tt.train_step(batch, perturb=False)
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-2)
    jl, tl = _leaves(jgrads), _leaves(convert.params_to_flax(grads))
    assert jl.keys() == tl.keys() and len(jl) == 8
    for p, gj in jl.items():
        _close(tl[p], gj, 3e-2)


# ---------------------------------------------------------------- SD stack
def _unet_pair():
    cfg = dict(UNET_TINY, attention_head_dim=4)
    ju = JUNet(JUNetConfig(**cfg, dtype="bfloat16"))
    params = random_params(jax.eval_shape(
        ju.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, CTX))), 1)
    tu = UNet2DCondition(UNetConfig(**cfg, dtype="bfloat16"))
    tu.load_state_dict(state_from_flax(params))
    return ju, _to_bf16(params), tu.to(torch.bfloat16).eval()


def test_unet_and_vae_in_bf16_match_jax():
    """ε of a tiny UNet and the posterior mean of a tiny VAE, both sides
    computing in bf16 on bf16-stored weights; ε and the mean come out f32."""
    ju, jp, tu = _unet_pair()
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 7, CTX).astype(np.float32)
    t = np.array([37, 512])
    want = np.asarray(jax.jit(ju.apply)(jp, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                                        jnp.asarray(ctx)))
    assert want.dtype == np.float32
    with torch.no_grad():
        got = tu(nchw(x), torch.tensor(t), torch.tensor(ctx))
    assert got.dtype == torch.float32
    _close(got.numpy(), want.transpose(0, 3, 1, 2), 3e-2)

    jv = JVAE(JVAEConfig(**VAE_TINY, dtype="bfloat16"))
    vp = random_params(jax.eval_shape(
        lambda k: jv.init({"params": k}, jnp.zeros((1, 16, 16, 3)), k),
        jax.random.PRNGKey(0)), 2)
    tv = AutoencoderKL(VAEConfig(**VAE_TINY, dtype="bfloat16"))
    tv.load_state_dict(state_from_flax(vp))
    tv = tv.to(torch.bfloat16).eval()
    img = rs.rand(1, 16, 16, 3).astype(np.float32) * 2 - 1
    jmean, _ = jv.apply(_to_bf16(vp), jnp.asarray(img), method=jv.moments)
    with torch.no_grad():
        tmean, _ = tv.moments(nchw(img))
    assert tmean.dtype == torch.float32
    _close(tmean.numpy(), np.asarray(jmean).transpose(0, 3, 1, 2), 3e-2)


def test_sds_gradient_on_the_bf16_stack_matches_jax():
    """One SDS gradient (text-anchored cfg 100) from the bf16 UNet, formed in
    f32 on both sides."""
    ju, jp, tu = _unet_pair()
    jopt = jconfig.Config(data_type="synthetic", lambda_sd=0.01, cfg=100.0,
                          sd_version="1.5")
    g = JGuidance.__new__(JGuidance)
    g.opt, g.unet, g.unet_params, g.cd_kv = jopt, ju, jp, None
    g.scheduler = jsched.DDPMSchedule()
    g.alphas = g.scheduler.alphas_cumprod
    latents = jax.random.normal(jax.random.PRNGKey(1), (1, 8, 8, 4))
    text = jax.random.normal(jax.random.PRNGKey(2), (2, 7, CTX))
    key = jax.random.PRNGKey(3)
    loss_fn = g.sds_loss_fn()
    want = jax.jit(jax.grad(lambda l: loss_fn(jp, l, text, jnp.int32(300), key)[0]))(latents)
    noise = jax.random.normal(key, latents.shape, dtype=latents.dtype)

    from test_torch_guidance import _port_opt, _tiny_text
    tg = StableDiffusionGuidance(
        _port_opt(), device="cpu", unet_cfg=UNetConfig(**UNET_TINY, attention_head_dim=4),
        vae_cfg=VAEConfig(**VAE_TINY), text_encoder=_tiny_text(), dtype="bfloat16")
    assert tg.unet.conv_in.weight.dtype == torch.bfloat16
    tg.unet.load_state_dict(tu.state_dict())
    grad, _ = tg.sds_grad(nchw(latents), torch.tensor(np.asarray(text)), 300, nchw(noise))
    assert grad.dtype == torch.float32
    _close(grad.numpy(), np.asarray(want).transpose(0, 3, 1, 2), 3e-2)


def test_one_tuning_step_on_the_bf16_stack_matches_jax(tmp_path, monkeypatch):
    """One Custom Diffusion step (prior preservation) on bf16 UNet and VAE:
    the loss, and the gradients of the adapters (f32 master weights in the
    port) and of the token row."""
    import test_torch_custom_diffusion as tcd
    jg, tg = tcd.make_pair(seed=1)
    up, vp, _, _ = tcd._params()
    jg.unet = JUNet(JUNetConfig(**UNET_TINY, attention_head_dim=4, dtype="bfloat16"))
    jg.vae = JVAE(JVAEConfig(**tcd.VAE_8X, dtype="bfloat16"))
    jg.unet_params, jg.vae_params = _to_bf16(up), _to_bf16(vp)
    tg = StableDiffusionGuidance(tg.opt, device="cpu", text_encoder=tg.text_encoder,
                                 unet_cfg=UNetConfig(**UNET_TINY, attention_head_dim=4),
                                 vae_cfg=VAEConfig(**tcd.VAE_8X), dtype="bfloat16")
    tg.unet.load_state_dict(state_from_flax(up))
    tg.vae.load_state_dict(state_from_flax(vp))
    assert tg.vae.encoder.conv_in.weight.dtype == torch.bfloat16
    inst = tcd._concept_images(str(tmp_path / "inst"), [(tcd.SIZE, tcd.SIZE)] * 3)
    cls = tcd._concept_images(str(tmp_path / "cls"), [(tcd.SIZE, tcd.SIZE)] * 2, seed=5)
    kw = dict(instance_prompt="ball", class_dir=cls, class_prompt="ball", steps=1,
              lr=1e-3, image_size=tcd.SIZE, batch_size=1, grad_accum=1,
              freeze_model="crossattn_kv", checkpointing_steps=0)
    seen, real_jit = [], jax.jit

    def spy_jit(fn, **k):
        f = real_jit(fn, **k)

        def run(*a, **kk):
            out = f(*a, **kk)
            if isinstance(out, tuple) and len(out) == 2 and getattr(out[0], "ndim", 1) == 0:
                seen.append(out)                      # value_and_grad's (loss, grads)
            return out
        return run

    monkeypatch.setattr("customnerf_tpu.guidance.sds.StableDiffusionGuidance",
                        lambda opt_: jg)
    monkeypatch.setattr(jax, "jit", spy_jit)
    jcd.train_custom_diffusion(jg.opt, instance_dir=inst, output_dir=str(tmp_path / "jax"),
                               **kw)
    monkeypatch.undo()
    (jloss, jgrads), = seen

    tables, got = [], {}
    extract, step = cd.extract_cd_kv, torch.optim.AdamW.step
    monkeypatch.setattr(cd, "extract_cd_kv",
                        lambda *a, **k: tables.append(extract(*a, **k)) or tables[-1])

    def capture(self, *a, **k):
        ps = [p for group in self.param_groups for p in group["params"]]
        got["grads"] = [p.grad.clone() for p in ps]
        return step(self, *a, **k)

    monkeypatch.setattr(torch.optim.AdamW, "step", capture)
    losses = []
    cd.train_custom_diffusion(tg.opt, instance_dir=inst, output_dir=str(tmp_path / "port"),
                              guidance=tg, draws=tcd._jax_draws(1, 1, True),
                              log=lambda *_: None, on_step=lambda s, v: losses.append(v),
                              **kw)
    assert losses[0] == pytest.approx(float(jloss), rel=1e-2)
    table, = tables
    assert all(v.dtype == torch.float32 for e in table.values() for v in e.values())
    *kv_grads, row_grad = got["grads"]
    port = {k: {n: None for n in e} for k, e in table.items()}
    it = iter(kv_grads)
    for k in port:
        for n in port[k]:
            port[k][n] = next(it)
    want = cd.cd_kv_from_flax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), jgrads["cd_kv"]))
    assert set(want) == set(port)
    for k in want:
        for n in want[k]:
            _close(port[k][n].numpy(), want[k][n].numpy(), 5e-2)
    _close(row_grad.numpy(), np.asarray(jgrads["tok_row"], np.float32), 5e-2)
    # the artifacts keep their f32 bytes
    tkv, _ = cd.load_cd_artifacts(str(tmp_path / "port"))
    assert all(v.dtype == torch.float32 for e in tkv.values() for v in e.values())


# ---------------------------------------------------------------- dispatch
DISPATCH = {
    # flags: (compute dtype, fused head's bf16 mode)
    "O": ("-O", "bfloat16", True),
    "O2": ("-O2", "bfloat16", True),
    "fp16": ("--fp16", "bfloat16", True),
    "none": ("", "float32", False),
    "O_backend_pallas": ("-O --backend pallas", "bfloat16", False),
    "O2_backend_pallas": ("-O2 --backend pallas", "bfloat16", False),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_flags_select_the_jax_head_and_dt_mode(case, monkeypatch):
    """Each flag set's field: the compute dtype of ``trainer.py:117``, the
    fused head's mode (bf16 only with ``--backend xla``), dT's bf16
    operands whatever the flags, as the JAX package's ``build_field``."""
    flags, dtype, head_bf16 = DISPATCH[case]
    base = ("--grid_type triplane --triplane_res 8 16 --triplane_channels 4 4 "
            "--data_type synthetic").split()
    topt = tconfig.parse_args(base + flags.split())
    jopt = jconfig.parse_args(base + flags.split())
    field = ttrainer.build_field(topt, device="cpu")
    assert field.cfg.compute_dtype == dtype == jtrainer.build_field(jopt).cfg.compute_dtype
    assert field.fused and field.fused_bf16 == head_bf16
    assert field.cfg.grid.mm_bf16 and not field.cfg.grid.fwd_bf16
    calls = {"head": [], "dt": []}
    head, dt = tfield.fused_field_mlp, triplane.plane_dtable
    monkeypatch.setattr(tfield, "fused_field_mlp", lambda *a, **k: calls["head"].append(
        k.get("bf16")) or head(*a, **k))
    monkeypatch.setattr(triplane, "plane_dtable", lambda *a, **k: calls["dt"].append(
        k.get("bf16")) or dt(*a, **k))
    x = torch.rand(64, 3) * 2 - 1
    dirs = torch.nn.functional.normalize(torch.randn(64, 3), dim=-1)
    sigma, rad = field(x, dirs)
    (sigma.sum() + rad.sum()).backward()
    field.density(x)
    assert calls["head"] == [head_bf16, head_bf16] and set(calls["dt"]) == {True}
    assert sigma.dtype == rad.dtype == torch.float32


def test_variant_heads_follow_fp16_under_either_backend():
    """The variant heads are flax's under either backend (``make_pallas_apply``
    covers the default head only): bf16 under fp16."""
    for backend in ("xla", "pallas"):
        opt = tconfig.parse_args(f"-O --mask_no_dir --backend {backend}".split())
        field = ttrainer.build_field(opt, device="cpu")
        assert not field.fused and field.cfg.dtype == torch.bfloat16


def test_sd_dtype_rule():
    """bf16 on the card, f32 on the CPU (the JAX ``sds.py:60-66``); the CPU
    guidance is f32 unless asked, its text tower f32 either way."""
    assert sd_dtype("cuda") == sd_dtype(torch.device("cuda", 0)) == "bfloat16"
    assert sd_dtype("cpu") == "float32"
    from test_torch_guidance import _port_opt, _tiny_text
    cfgs = dict(unet_cfg=UNetConfig(**UNET_TINY, attention_head_dim=4),
                vae_cfg=VAEConfig(**VAE_TINY))
    for dtype, want in ((None, torch.float32), ("bfloat16", torch.bfloat16)):
        g = StableDiffusionGuidance(_port_opt(), device="cpu", text_encoder=_tiny_text(),
                                    dtype=dtype, **cfgs)
        assert {p.dtype for m in (g.unet, g.vae) for p in m.parameters()} == {want}
        assert {p.dtype for p in g.text_encoder.model.parameters()} == {torch.float32}
        assert g.unet.cfg.compute_dtype == g.vae.cfg.compute_dtype == want
