"""The port's SD guidance against the JAX package's, on the CPU at tiny
widths: UNet ε, VAE moments / posterior sample / decode, the DDPM schedule,
the SDS cotangent, timestep sampling, ``--sd_weights`` loading, and the
full-width parameter counts.

Weights are random leaves for the JAX modules' param trees (norm scales
off 1 and biases off 0, so neither can hide a missing term), carried flax →
port through ``engine/convert.py::state_from_flax``.  Tolerances: ε, moments and
decode to 1e-4 of the output's largest entry (f32 through 20-40 layers whose
convolutions and matmuls XLA and PyTorch sum in other orders); the schedule
exactly; the SDS cotangent to 1e-4 of its largest entry (it is
(1−ᾱ)·λ·(ε̂−ε) with cfg = 100 amplifying ε's rounding).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu.config import Config as JConfig
from customnerf_tpu.guidance import scheduler as jsched
from customnerf_tpu.guidance.sds import StableDiffusionGuidance as JGuidance
from customnerf_tpu.guidance.unet import UNet2DCondition as JUNet, UNetConfig as JUNetConfig
from customnerf_tpu.guidance.vae import AutoencoderKL as JVAE, VAEConfig as JVAEConfig
from customnerf_torch.config import parse_args
from customnerf_torch.engine.convert import state_from_flax
from customnerf_torch.guidance import scheduler as tsched
from customnerf_torch.guidance.layers import build, n_params
from customnerf_torch.guidance.sds import (FULL_WIDTH_PARAMS,
                                          StableDiffusionGuidance)
from customnerf_torch.guidance.text import (CLIPTextConfig, CLIPTextModel,
                                            TextEncoder)
from customnerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from customnerf_torch.guidance.vae import AutoencoderKL, VAEConfig

sys.path.insert(0, os.path.dirname(__file__))
from torch_sd_mirror import TorchUNet, TorchVAE  # noqa: E402

CTX = 24


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers at once, and their threads spinning over these tiny ops contend
    for the cores (a tenfold slowdown measured on an 8-core CPU)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

UNET_TINY = dict(block_out_channels=(32, 64), layers_per_block=2,
                 cross_attention_dim=CTX, norm_num_groups=8)
VAE_TINY = dict(block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4)


def random_params(shapes, seed):
    """Random leaves for a tree of shapes (no XLA compile): kernels
    N(0, 1/fan_in), norm scales 1 + N(0, 0.05²), everything else
    N(0, 0.05²)."""
    rs = np.random.RandomState(seed)

    def leaf(path, s):
        name = getattr(path[-1], "key", "")
        a = rs.randn(*s.shape).astype(np.float32)
        if name == "kernel":
            return a / np.sqrt(np.prod(s.shape[:-1]))
        return (1.0 if name == "scale" else 0.0) + 0.05 * a

    return jax.tree_util.tree_map_with_path(leaf, shapes)


_JIT = {}


def japply(ju):
    """One jitted apply per UNet config, shared by the tests of this file
    (XLA's compile is most of their time)."""
    if ju.cfg not in _JIT:
        _JIT[ju.cfg] = jax.jit(ju.apply)
    return _JIT[ju.cfg]


def unet_pair(heads):
    cfg = dict(UNET_TINY, attention_head_dim=heads)
    ju = JUNet(JUNetConfig(**cfg))
    params = random_params(jax.eval_shape(
        ju.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, CTX))), 1)
    tu = UNet2DCondition(UNetConfig(**cfg))
    tu.load_state_dict(state_from_flax(params))
    return ju, params, tu.eval()


def vae_pair():
    jv = JVAE(JVAEConfig(**VAE_TINY))
    params = random_params(jax.eval_shape(
        lambda k: jv.init({"params": k}, jnp.zeros((1, 16, 16, 3)), k),
        jax.random.PRNGKey(0)), 2)
    tv = AutoencoderKL(VAEConfig(**VAE_TINY))
    tv.load_state_dict(state_from_flax(params))
    return jv, params, tv.eval()


def nchw(a):
    return torch.tensor(np.asarray(a).transpose(0, 3, 1, 2).copy())


def close(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("heads", [4, (2, 4)], ids=["uniform_heads", "per_level_heads"])
def test_unet_eps_matches_jax(heads):
    ju, params, tu = unet_pair(heads)
    rs = np.random.RandomState(3)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 7, CTX).astype(np.float32)
    t = np.array([37, 512])
    want = np.asarray(japply(ju)(params, jnp.asarray(x), jnp.asarray(t, jnp.int32),
                               jnp.asarray(ctx))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = tu(nchw(x), torch.tensor(t), torch.tensor(ctx)).numpy()
    close(got, want)


def test_convert_is_the_inverse_of_the_jax_weight_loader():
    """torch mirror (diffusers keys) → JAX ``convert_unet``/``convert_vae``
    → flax → ``state_from_flax`` gives back the mirror's state dict."""
    from customnerf_tpu.guidance.weights import convert_unet, convert_vae
    tm = TorchUNet(**UNET_TINY, attention_head_dim=4)
    ju = JUNet(JUNetConfig(**UNET_TINY, attention_head_dim=4))
    p = jax.eval_shape(ju.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
                       jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, CTX)))
    p = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), p)
    src = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    back = state_from_flax(jax.tree_util.tree_map(np.asarray, convert_unet(src, p)))
    assert back.keys() == src.keys()
    for k, v in src.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    tv = TorchVAE(block_out_channels=(16, 32), layers_per_block=1, groups=4)
    jv = JVAE(JVAEConfig(**VAE_TINY))
    p = jax.eval_shape(lambda k: jv.init({"params": k}, jnp.zeros((1, 16, 16, 3)), k),
                       jax.random.PRNGKey(0))
    p = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), p)
    src = {k: v.detach().numpy() for k, v in tv.state_dict().items()}
    back = state_from_flax(jax.tree_util.tree_map(np.asarray, convert_vae(src, p)))
    assert back.keys() == src.keys()
    for k, v in src.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_vae_moments_sample_and_decode_match_jax():
    jv, params, tv = vae_pair()
    rs = np.random.RandomState(5)
    img = rs.rand(2, 16, 16, 3).astype(np.float32)
    key = jax.random.PRNGKey(9)
    mean, logvar = jax.jit(lambda p, x: jv.apply(p, x, method=jv.moments))(
        params, jnp.asarray(2 * img - 1))
    z = jax.jit(lambda p, x, k: jv.apply(p, x, k, method=jv.encode))(
        params, jnp.asarray(2 * img - 1), key)
    noise = jax.random.normal(key, mean.shape, dtype=mean.dtype)
    with torch.no_grad():
        tm, tl = tv.moments(nchw(2 * img - 1))
        tz = tv.encode(nchw(2 * img - 1), noise=nchw(noise))
    close(tm.numpy(), np.asarray(mean).transpose(0, 3, 1, 2))
    close(tl.numpy(), np.asarray(logvar).transpose(0, 3, 1, 2))
    close(tz.numpy(), np.asarray(z).transpose(0, 3, 1, 2))
    lat = rs.randn(2, 2, 2, 4).astype(np.float32)
    dec = jax.jit(lambda p, z: jv.apply(p, z, method=jv.decode))(params, jnp.asarray(lat))
    with torch.no_grad():
        close(tv.decode(nchw(lat)).numpy(), np.asarray(dec).transpose(0, 3, 1, 2))


def test_ddpm_schedule_is_exact():
    j, t = jsched.DDPMSchedule(), tsched.DDPMSchedule()
    np.testing.assert_array_equal(t.alphas_cumprod.numpy(), np.asarray(j.alphas_cumprod))
    rs = np.random.RandomState(0)
    x, e = rs.randn(2, 3, 4, 4).astype(np.float32), rs.randn(2, 3, 4, 4).astype(np.float32)
    want = np.asarray(j.add_noise(jnp.asarray(x), jnp.asarray(e), jnp.asarray([10, 700])))
    got = t.add_noise(torch.tensor(x), torch.tensor(e), torch.tensor([10, 700])).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _port_opt(*extra):
    return parse_args(["--data_type", "synthetic", "--lambda_sd", "0.01",
                       "--cfg", "100", "--stage_time", "--iters", "100", *extra])


def _tiny_text(device="cpu"):
    gen = torch.Generator(device=device).manual_seed(0)
    return TextEncoder(model=build(
        CLIPTextModel, CLIPTextConfig(hidden_size=CTX, intermediate_size=48,
                                      num_hidden_layers=2, num_attention_heads=4),
        device=device, generator=gen))


def port_guidance(opt, heads=4):
    return StableDiffusionGuidance(
        opt, device="cpu", unet_cfg=UNetConfig(**UNET_TINY, attention_head_dim=heads),
        vae_cfg=VAEConfig(**VAE_TINY), text_encoder=_tiny_text())


def test_sds_cotangent_matches_jax():
    ju, params, tu = unet_pair(4)
    jopt = JConfig(data_type="synthetic", lambda_sd=0.01, cfg=100.0, sd_version="1.5")
    g = JGuidance.__new__(JGuidance)
    g.opt, g.unet, g.unet_params, g.cd_kv = jopt, ju, params, None
    g.scheduler = jsched.DDPMSchedule()
    g.alphas = g.scheduler.alphas_cumprod
    latents = jax.random.normal(jax.random.PRNGKey(1), (1, 8, 8, 4))
    text = jax.random.normal(jax.random.PRNGKey(2), (2, 7, CTX))
    key = jax.random.PRNGKey(3)
    loss_fn = g.sds_loss_fn()
    want = jax.jit(jax.grad(lambda l: loss_fn(params, l, text, jnp.int32(300), key)[0]))(
        latents)
    noise = jax.random.normal(key, latents.shape, dtype=latents.dtype)

    tg = port_guidance(_port_opt())
    tg.unet.load_state_dict(tu.state_dict())
    grad, loss = tg.sds_grad(nchw(latents), torch.tensor(np.asarray(text)), 300,
                             nchw(noise))
    close(grad.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    assert float(loss) == pytest.approx(0.5 * float(jnp.sum(want ** 2)), rel=1e-4)


def test_sample_timestep_range_and_stage_time():
    g = port_guidance(_port_opt())
    assert (g.min_step, g.max_step) == (20, 980)
    gen = torch.Generator().manual_seed(0)

    def draw(n, **kw):
        # t stays on the generator's device: a [1] int64 tensor, no host sync
        ts = [g.sample_timestep(gen, **kw) for _ in range(n)]
        assert all(t.dtype == torch.int64 and t.shape == (1,) for t in ts)
        return [int(t) for t in ts]

    early = draw(2000, global_step=10)
    assert min(early) == 20 and max(early) == 980          # inclusive randint
    late = draw(2000, global_step=51)
    assert min(late) == 20 and max(late) == 490             # halved past iters/2
    at_half = draw(500, global_step=50)
    assert max(at_half) > 490                               # not yet at iters/2
    ratio = draw(500, global_step=10, t_ratio=0.5)
    assert max(ratio) <= 490 and min(ratio) >= 10
    g2 = port_guidance(_port_opt("--max_ratio", "0.5"))
    assert g2.max_step == 500


def test_guards_and_unported_versions():
    with pytest.raises(RuntimeError, match="--sd_weights"):
        StableDiffusionGuidance(_port_opt("--pretrained"), device="cpu")
    # SD 2.x is ported: --sd_version 2.1 builds the JAX package's 2.x shapes
    # (on the meta device here: the full-width f32 stack is ~5 GB)
    from customnerf_tpu.guidance.text import _text_config
    from customnerf_tpu.guidance.unet import sd2_unet_config
    g2 = StableDiffusionGuidance(_port_opt("--sd_version", "2.1"), device="meta")
    want = sd2_unet_config()
    assert (g2.unet.cfg.cross_attention_dim, g2.unet.cfg.attention_head_dim,
            g2.unet.cfg.block_out_channels) == (want.cross_attention_dim,
                                                 want.attention_head_dim,
                                                 want.block_out_channels)
    jt, tt = _text_config("2.1"), g2.text_encoder.model.text_model.cfg
    assert (tt.hidden_size, tt.num_hidden_layers, tt.num_attention_heads,
            tt.hidden_act) == (jt.hidden_size, jt.num_hidden_layers,
                               jt.num_attention_heads, jt.hidden_act)
    assert g2.param_counts() == {k: v for k, v in FULL_WIDTH_PARAMS["2.x"].items()
                                 if k != "clip_view"}
    # --use_cd is ported: an artifact directory's adapters and token load
    # (outside --test), a missing one leaves the stack as it is, as in JAX
    import tempfile
    from customnerf_torch.guidance.custom_diffusion import extract_cd_kv, save_cd_artifacts
    with tempfile.TemporaryDirectory() as d:
        plain = port_guidance(_port_opt())
        save_cd_artifacts(d, extract_cd_kv(plain.unet), {"<new1>": torch.ones(CTX)})
        g = port_guidance(_port_opt("--use_cd", d))
        assert set(g.cd_kv) == set(extract_cd_kv(plain.unet))
        assert g.text_encoder.tokenizer.add_token("<new1>") == 49408
        assert port_guidance(_port_opt("--use_cd", d, "--test")).cd_kv is None
        assert port_guidance(_port_opt("--use_cd", os.path.join(d, "none"))).cd_kv is None


def test_sd_weights_dir_gives_the_same_eps_as_jax(tmp_path, capsys):
    """A diffusers-layout directory written from the torch mirror (the VAE
    under its older attention names) loads through the JAX
    ``load_sd_weights`` and through the port's to the same ε and moments;
    the text encoder's HF state dict and the tokenizer load in the port."""
    from customnerf_tpu.guidance.weights import load_sd_weights as jload
    torch.manual_seed(0)
    tm = TorchUNet(**UNET_TINY, attention_head_dim=4)
    tv = TorchVAE(block_out_channels=(16, 32), layers_per_block=1, groups=4)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in list(tm.parameters()) + list(tv.parameters()):
            p.add_(0.05 * torch.randn(p.shape, generator=g))
    old = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
    vae_sd = {}
    for k, v in tv.state_dict().items():
        for new, o in old.items():
            k = k.replace(f"attentions.0.{new}.", f"attentions.0.{o}.")
        vae_sd[k] = v
    text = _tiny_text()
    te_sd = dict(text.model.state_dict())
    te_sd["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    for sub, sd, name in (("unet", tm.state_dict(), "diffusion_pytorch_model.bin"),
                          ("vae", vae_sd, "diffusion_pytorch_model.bin"),
                          ("text_encoder", te_sd, "pytorch_model.bin")):
        os.makedirs(tmp_path / sub)
        torch.save(sd, tmp_path / sub / name)

    ju = JUNet(JUNetConfig(**UNET_TINY, attention_head_dim=4))
    jv = JVAE(JVAEConfig(**VAE_TINY))
    jg = JGuidance.__new__(JGuidance)
    zeros = lambda t: jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), t)
    jg.unet_params = zeros(jax.eval_shape(
        ju.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, CTX))))
    jg.vae_params = zeros(jax.eval_shape(
        lambda k: jv.init({"params": k}, jnp.zeros((1, 16, 16, 3)), k),
        jax.random.PRNGKey(0)))
    jg.text_encoder = None
    jload(jg, str(tmp_path))

    opt = _port_opt("--sd_weights", str(tmp_path))
    tg = StableDiffusionGuidance(opt, device="cpu",
                                 unet_cfg=UNetConfig(**UNET_TINY, attention_head_dim=4),
                                 vae_cfg=VAEConfig(**VAE_TINY),
                                 text_encoder=TextEncoder(model=build(
                                     CLIPTextModel, text.model.text_model.cfg)))
    for k, v in text.model.state_dict().items():
        assert torch.equal(tg.text_encoder.model.state_dict()[k], v), k

    rs = np.random.RandomState(4)
    x = rs.randn(2, 8, 8, 4).astype(np.float32)
    ctx = rs.randn(2, 7, CTX).astype(np.float32)
    want = japply(ju)(jg.unet_params, jnp.asarray(x), jnp.asarray([5, 900], jnp.int32),
                    jnp.asarray(ctx))
    with torch.no_grad():
        got = tg.unet(nchw(x), torch.tensor([5, 900]), torch.tensor(ctx))
    close(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    img = rs.rand(1, 16, 16, 3).astype(np.float32) * 2 - 1
    jm, _ = jv.apply(jg.vae_params, jnp.asarray(img), method=jv.moments)
    with torch.no_grad():
        tmean, _ = tg.vae.moments(nchw(img))
    close(tmean.numpy(), np.asarray(jm).transpose(0, 3, 1, 2))


def _jax_count(fn, *args):
    shapes = jax.eval_shape(fn, *args)
    return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))


def test_full_width_parameter_counts_equal_the_jax_package():
    """The port built on the ``meta`` device; the JAX modules through
    ``jax.eval_shape`` of their init; both equal ``FULL_WIDTH_PARAMS["1.x"]``."""
    from transformers import FlaxCLIPModel, FlaxCLIPTextModel
    from customnerf_tpu.guidance.clip_view import _vit_b32_config
    from customnerf_tpu.guidance.text import _text_config
    from customnerf_torch.guidance.clip_view import CLIPModel
    key = jax.random.PRNGKey(0)
    ju, jv = JUNet(JUNetConfig()), JVAE(JVAEConfig())
    jax_counts = {
        "unet": _jax_count(ju.init, key, jnp.zeros((1, 8, 8, 4)),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 768))),
        "vae": _jax_count(lambda k: jv.init({"params": k}, jnp.zeros((1, 64, 64, 3)), k),
                          key),
        "text_encoder": _jax_count(
            lambda k: FlaxCLIPTextModel(_text_config("1.5"), _do_init=False)
            .init_weights(k, (1, 77)), key),
        "clip_view": _jax_count(
            lambda k: FlaxCLIPModel(_vit_b32_config(), _do_init=False)
            .init_weights(k, ((1, 77), (1, 224, 224, 3))), key),
    }
    port_counts = {
        "unet": n_params(build(UNet2DCondition, UNetConfig(), device="meta")),
        "vae": n_params(build(AutoencoderKL, VAEConfig(), device="meta")),
        "text_encoder": n_params(build(CLIPTextModel, CLIPTextConfig(), device="meta")),
        "clip_view": n_params(build(CLIPModel, device="meta")),
    }
    assert port_counts == jax_counts == FULL_WIDTH_PARAMS["1.x"]
