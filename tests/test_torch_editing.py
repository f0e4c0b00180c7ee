"""One LGIE/SDS editing step of the port against the JAX package's
components, in both LGIE branches and with ``--ori_bg`` on and off: the same
field, occupancy grid, frame, frozen-render (pt) entry, text embeddings, t,
bg colour and noises; march jitter off on both sides.

The JAX step is composed here from the JAX package's own pieces, as its
``_build_editing_step`` composes them: ``render_rays_fast``, the bilinear
``jax.image.resize`` (to 64² instead of 512², as ``tests/test_editing.py``
shrinks it; the port reads the size from ``engine/editing.py::RESIZE``), the
guidance's ``encode_imgs_fn`` and ``sds_loss_fn`` on a tiny UNet/VAE, and
the surrogate ``sum(latents · sg(cotangent)) + keep_bg · L1``.

Tolerances: ``loss_bg`` 1e-5 relative (an L1 over the same composites);
``loss_sds`` 1e-4 relative and the parameter gradients 1e-3 of each leaf's
largest entry — the cotangent is (1−ᾱ)·λ·(ε̂−ε) with ε̂ = 101·ε_text −
100·ε_uncond, which multiplies the UNet's f32 rounding by 100 before it
flows back through the VAE encoder and the render (measured: ≤ 2.1e-6 and
≤ 1.6e-4; the SDS term makes 6-120 % of each leaf's largest entry).
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
from customnerf_tpu.guidance.scheduler import DDPMSchedule as JSchedule
from customnerf_tpu.guidance.sds import StableDiffusionGuidance as JGuidance
from customnerf_tpu.guidance.unet import UNet2DCondition as JUNet, UNetConfig as JUNetConfig
from customnerf_tpu.guidance.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from customnerf_tpu.models import field as jfield
from customnerf_tpu.models import renderer as jren
from customnerf_tpu.ops import occupancy as jocc
from customnerf_torch import config as tconfig
from customnerf_torch.data.base import NeRFDataset
from customnerf_torch.engine import convert, editing
from customnerf_torch.engine.trainer import Trainer, build_field
from customnerf_torch.guidance.layers import build
from customnerf_torch.guidance.sds import StableDiffusionGuidance
from customnerf_torch.guidance.text import CLIPTextConfig, CLIPTextModel, TextEncoder
from customnerf_torch.guidance.unet import UNetConfig
from customnerf_torch.guidance.vae import VAEConfig
from customnerf_torch.ops import occupancy as tocc

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guidance import one_thread, random_params  # noqa: E402,F401

FLAGS = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 2 "
         "--num_steps 16 --upsample_steps 0 --compact_frac 0.5 "
         "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
         "--data_type synthetic --occ_grid_size 16 --iters 100 --lr 0.01 "
         "--h 16 --w 16 --train_size 4 --max_ray_batch 1000 --pretrained "
         "--lambda_sd 0.01 --keep_bg 10 --cfg 100 --random_bg_c --detach_bg "
         "--stage_time --allow_random_guidance --use_ckpt scratch").split()
UNET = dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
            cross_attention_dim=32, attention_head_dim=4, norm_num_groups=8)
VAE = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=8)
SIDE = 64
G = 16
T = 420


def quiet(*_):
    pass


def tiny_guidance(opt):
    text = TextEncoder(model=build(
        CLIPTextModel, CLIPTextConfig(hidden_size=32, intermediate_size=64,
                                      num_hidden_layers=2, num_attention_heads=4),
        generator=torch.Generator().manual_seed(0)))
    return StableDiffusionGuidance(opt, device="cpu", unet_cfg=UNetConfig(**UNET),
                                   vae_cfg=VAEConfig(**VAE), text_encoder=text)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Everything both sides share, and the JAX step's compiled pieces."""
    ws = str(tmp_path_factory.mktemp("edit"))
    jopt = jconfig.parse_args(FLAGS)
    topt = tconfig.parse_args(FLAGS + ["--workspace", ws])
    rng = np.random.RandomState(0)
    params = convert.params_to_flax(build_field(topt, device="cpu").state_dict())
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.3).astype(np.float32)
    dens = (rng.rand(2, G ** 3) < 0.5).astype(np.float32) * 50.0
    occ = jocc.state_from_grid(dens, 1.0, density_thresh=10.0, grid_size=G)
    batch = NeRFDataset(topt, "train", device="cpu").dataloader().item(0)
    H, W = batch.H, batch.W
    o, d = batch.rays_o.numpy(), batch.rays_d.numpy()
    gt = batch.rgbs.numpy().reshape(H, W, 3)

    ju, jv = JUNet(JUNetConfig(**UNET)), JVAE(JVAEConfig(**VAE))
    key = jax.random.PRNGKey(0)
    unet_p = random_params(jax.eval_shape(ju.init, key, jnp.zeros((1, 8, 8, 4)),
                                          jnp.zeros((1,), jnp.int32),
                                          jnp.zeros((1, 77, 32))), 1)
    vae_p = random_params(jax.eval_shape(
        lambda k: jv.init({"params": k}, jnp.zeros((1, 64, 64, 3)), k), key), 2)
    jg = JGuidance.__new__(JGuidance)
    jg.opt, jg.unet, jg.vae, jg.cd_kv = jopt, ju, jv, None
    jg.scheduler = JSchedule()
    jg.alphas = jg.scheduler.alphas_cumprod

    spec = dataclasses.replace(jtrainer.build_encoder_spec(jopt), mm_bf16=False)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=2.0, grid=spec))
    s = jtrainer.render_settings(jopt)
    encode, sds_loss = jg.encode_imgs_fn(), jg.sds_loss_fn()
    n_keep = jopt.num_steps

    def render(p, bg):
        return jren.render_rays_fast(jf, p, jnp.asarray(o), jnp.asarray(d), occ,
                                     key, s, n_coarse=2 * n_keep, n_keep=n_keep,
                                     train=True, perturb=False, bg_color=bg,
                                     compact_frac=0.5, compact_block=8)

    @jax.jit
    def pt_fn(p, bg):
        out = render(p, bg)
        return out["bg"]["image"].reshape(H, W, 3), out["render_mask"].reshape(H, W, -1)

    @jax.jit
    def loss_grad(p, bg, use_fg, ori, pt_bg, pt_mask, cot, k_vae):
        def loss_fn(p):
            out = render(p, bg)
            img = jnp.where(use_fg > 0.5, out["fg"]["image"], out["image"]).reshape(H, W, 3)
            img = jax.image.resize(img[None], (1, SIDE, SIDE, 3), method="bilinear")
            latents = encode(vae_p, img, k_vae)
            pred_bg = out["bg"]["image"].reshape(H, W, 3)
            pred_mask = out["render_mask"].reshape(H, W, -1)
            non_edit = (pt_mask.mean(-1, keepdims=True)
                        + pred_mask.mean(-1, keepdims=True)) < 0.5
            target = jnp.where((ori > 0.5) & non_edit, gt, pt_bg)
            loss_sd = jnp.sum(latents * jax.lax.stop_gradient(cot))
            loss_bg = jopt.keep_bg * jnp.mean(jnp.abs(target - pred_bg))
            return loss_sd + loss_bg, (latents, loss_bg)
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    sds_grad = jax.jit(jax.grad(lambda l, e, k: sds_loss(unet_p, l, e, jnp.int32(T), k)[0]))
    tg = tiny_guidance(topt)
    tg.unet.load_state_dict(convert.state_from_flax(unet_p))
    tg.vae.load_state_dict(convert.state_from_flax(vae_p))
    text = {b: np.asarray(jax.random.normal(jax.random.PRNGKey(7 + i), (2, 77, 32)))
            for i, b in enumerate(("global", "local"))}
    return dict(topt=topt, params=params, dens=dens, batch=batch, pt_fn=pt_fn,
                loss_grad=loss_grad, sds_grad=sds_grad, tg=tg, text=text)


def _port_trainer(w, *flags):
    opt = dataclasses.replace(w["topt"], **{f: True for f in flags})
    field = build_field(opt, device="cpu")
    field.load_state_dict(convert.params_from_flax(w["params"]))
    tr = Trainer(opt, field=field, device="cpu", log=quiet, guidance=w["tg"])
    tr.occ_state = tocc.state_from_grid(torch.tensor(w["dens"]), 1.0, 10.0, grid_size=G)
    return tr


@pytest.mark.parametrize("ori_bg", [False, True], ids=["keep_pt_bg", "ori_bg"])
@pytest.mark.parametrize("branch", ["global", "local"])
def test_editing_step_matches_jax(world, monkeypatch, branch, ori_bg):
    w = world
    jp = jax.tree_util.tree_map(jnp.asarray, w["params"])
    bg = jnp.asarray([0.2, 0.5, 0.9], jnp.float32)
    # the pt entry from other (pretrained) weights, so keep_bg has work to do
    pre = jax.tree_util.tree_map(lambda a: a, jp)
    pre["params"]["grid_table"] = jp["params"]["grid_table"][::-1]
    pt_bg, pt_mask = w["pt_fn"](pre, bg)
    use_fg = jnp.float32(branch == "local")
    k_vae, k_noise = jax.random.split(jax.random.PRNGKey(11 if ori_bg else 12))
    zero_cot = jnp.zeros((1, 8, 8, 4))
    (_, (latents, _)), _ = w["loss_grad"](jp, bg, use_fg, jnp.float32(ori_bg), pt_bg,
                                          pt_mask, zero_cot, k_vae)
    text = w["text"][branch]
    cot = w["sds_grad"](latents, jnp.asarray(text), k_noise)
    (_, (_, loss_bg)), grads = w["loss_grad"](jp, bg, use_fg, jnp.float32(ori_bg),
                                              pt_bg, pt_mask, cot, k_vae)
    loss_sds = 0.5 * float(jnp.sum(cot ** 2))
    vae_noise = jax.random.normal(k_vae, (1, 8, 8, 4))
    noise = jax.random.normal(k_noise, (1, 8, 8, 4))

    flags = ("l_only" if branch == "local" else "g_only",) + (("ori_bg",) if ori_bg else ())
    tr = _port_trainer(w, *flags)
    nchw = lambda a: torch.tensor(np.asarray(a).transpose(0, 3, 1, 2).copy())
    tr.text_z = torch.tensor(w["text"]["global"])
    tr.text_z_fg = torch.tensor(w["text"]["local"])
    batch = w["batch"]
    tr.pt_dict[batch.img_path] = dict(pt_rgb_bg=torch.tensor(np.asarray(pt_bg)),
                                      pt_mask=torch.tensor(np.asarray(pt_mask)),
                                      match_probs=None)
    monkeypatch.setattr(editing, "RESIZE", SIDE)
    loss, aux, stats = editing.editing_step(
        tr, batch, perturb=False,
        draws=dict(bg_color=torch.tensor(np.asarray(bg)), t=T, noise=nchw(noise),
                   vae_noise=nchw(vae_noise)))
    assert stats["local"] == (branch == "local") and stats["t"] == T
    assert float(aux["loss_bg"]) == pytest.approx(float(loss_bg), rel=1e-5)
    assert float(aux["loss_sds"]) == pytest.approx(loss_sds, rel=1e-4)
    assert float(loss) == pytest.approx(float(aux["loss_bg"]) + float(aux["loss_sds"]))
    tgrads = convert.params_to_flax({n: p.grad for n, p in tr.field.named_parameters()})
    jl = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, grads)))
    tl = dict(jax.tree_util.tree_leaves_with_path(tgrads))
    assert jl.keys() == tl.keys() and len(jl) == 8
    for path, gj in jl.items():
        scale = np.abs(gj).max()
        assert scale > 0, path
        np.testing.assert_allclose(tl[path], gj, rtol=0, atol=1e-3 * scale,
                                   err_msg=jax.tree_util.keystr(path))


def test_lgie_gate_draws_the_jax_stream(world):
    """The gate takes ``numpy.random.RandomState(seed)``'s draws in order, as
    the JAX trainer's ``_np_rng`` (trainer.py:153, editing.py:291-300)."""
    tr = _port_trainer(world)
    want = np.random.RandomState(tr.opt.seed).random(32) < tr.opt.global_ratio
    got = [not editing._lgie_gate(tr, "z", "z_fg")[0] for _ in range(32)]
    assert got == list(want) and 0 < sum(got) < 32
    local = editing._lgie_gate(_port_trainer(world, "l_only"), "z", "z_fg")
    assert local == (True, "z_fg", tr.opt.local_t_ratio)


def test_pt_cache_fill_and_frozen_field(world, tmp_path, monkeypatch):
    """The pt render is taken once per image with the first step's bg
    colour, filled into the full image only; the frozen field loaded from
    --editing_from does not move while the trained one does."""
    w = world
    recon = _port_trainer(w)
    path = recon.save_checkpoint()
    opt = dataclasses.replace(w["topt"], editing_from=path, workspace=str(tmp_path))
    tr = Trainer(opt, device="cpu", log=quiet, guidance=w["tg"])
    assert tr.field_pretrained is not tr.field
    assert not any(p.requires_grad for p in tr.field_pretrained.parameters())
    frozen = [p.clone() for p in tr.field_pretrained.parameters()]
    batch = w["batch"]
    white = tr.render_image(batch.rays_o, batch.rays_d, bg_color=torch.ones(3),
                            field=tr.field_pretrained)
    none = tr.render_image(batch.rays_o, batch.rays_d, field=tr.field_pretrained)
    ws = none["weights_sum"]
    assert float((1 - ws).max()) > 0.01
    torch.testing.assert_close(white["image"], none["image"] + (1 - ws)[:, None])
    torch.testing.assert_close(white["bg"]["image"], none["bg"]["image"])

    monkeypatch.setattr(editing, "RESIZE", SIDE)
    before = [p.detach().clone() for p in tr.field.parameters()]
    for _ in range(2):
        loss, aux, _ = tr.train_step(batch)
        assert set(aux) == {"loss_sds", "loss_bg"} and bool(torch.isfinite(loss))
    assert list(tr.pt_dict) == [batch.img_path]
    assert tr.text_z.shape == (2, 77, 32) and tr.text_z_bg.shape == (2, 77, 32)
    assert all(torch.equal(a, b) for a, b in zip(tr.field_pretrained.parameters(), frozen))
    assert any(bool((a != b).any()) for a, b in zip(tr.field.parameters(), before))
