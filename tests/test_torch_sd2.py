"""SD 2.x (``--sd_version 2.0`` / ``2.1``) in the port against the JAX
package, on the CPU at reduced width: the exact-GELU text tower, the stack
the guidance builds for each version, a diffusers-layout 2.x directory
(linear ``proj_in``/``proj_out``), the SDS cotangent, one LGIE editing step,
one Custom Diffusion tuning step, the adapter artifacts, DDIM, merging, the
weights drill, the tokenizers' EOS padding, and the full-width counts.

The reduced 2.x shapes keep what sets 2.x apart from 1.5: per-level head
counts that make every head the same width (16 here, 64 at full width), a
context wider than 1.5's tiny one (48 against 24 or 32) and a text tower
with exact-erf GELU.  Weights are the JAX modules' random leaves carried
flax → port through ``engine/convert.py::state_from_flax``, as in
``tests/test_torch_guidance.py``; the JAX side of the editing and tuning
steps is composed and spied as in ``tests/test_torch_editing.py`` and
``tests/test_torch_custom_diffusion.py``, whose checks these tests call
with the 2.x stack.  Tolerances are theirs: hidden states 1e-5 of the
largest entry, ε and DDIM images 1e-4, the SDS cotangent 1e-4, the editing
step's gradients 1e-3 of each leaf's largest entry, the tuning loss 1e-5
relative and the adapters after AdamW 1e-5.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import CLIPTextConfig as HFTextConfig, FlaxCLIPTextModel

from customnerf_tpu.config import Config as JConfig
from customnerf_tpu.guidance import scheduler as jsched
from customnerf_tpu.guidance import text as jtext
from customnerf_tpu.guidance.sds import StableDiffusionGuidance as JGuidance
from customnerf_tpu.guidance.unet import (UNet2DCondition as JUNet,
                                          UNetConfig as JUNetConfig, sd2_unet_config)
from customnerf_torch.engine.convert import state_from_flax
from customnerf_torch.guidance import custom_diffusion as cd
from customnerf_torch.guidance import text as ttext
from customnerf_torch.guidance.layers import build, n_params
from customnerf_torch.guidance.sds import (FULL_WIDTH_PARAMS, StableDiffusionGuidance,
                                          sd_family, unet_config)
from customnerf_torch.guidance.unet import UNet2DCondition, UNetConfig
from customnerf_torch.guidance.vae import VAEConfig

sys.path.insert(0, os.path.dirname(__file__))
import test_torch_custom_diffusion as tcd  # noqa: E402
import test_torch_editing as ted  # noqa: E402
from test_torch_guidance import (VAE_TINY, _port_opt, close, nchw,  # noqa: E402
                                 one_thread, random_params)  # noqa: F401
from test_torch_text_clip import PROMPTS, tok_dir  # noqa: E402,F401

CTX2 = 48
TEXT2 = dict(hidden_size=CTX2, intermediate_size=96, num_hidden_layers=2,
             num_attention_heads=4, hidden_act="gelu")
# two levels as the tiny 1.5 UNet of the guidance tests; (2, 4) heads over
# (32, 64) channels: 16 wide at both levels
UNET2 = dict(block_out_channels=(32, 64), layers_per_block=2,
             cross_attention_dim=CTX2, attention_head_dim=(2, 4), norm_num_groups=8)
SD2 = tcd.Stack(unet=tuple(UNET2.items()), text=tuple(TEXT2.items()), linear_proj=True)
# the editing step's four-level UNet, heads (2, 4, 4, 4): 16 wide
UNET2_EDIT = dict(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                  cross_attention_dim=CTX2, attention_head_dim=(2, 4, 4, 4),
                  norm_num_groups=8)
UNET_FIELDS = ("in_channels", "out_channels", "block_out_channels", "layers_per_block",
               "cross_attention_dim", "attention_head_dim", "norm_num_groups")
TEXT_FIELDS = ("vocab_size", "hidden_size", "intermediate_size", "num_hidden_layers",
               "num_attention_heads", "max_position_embeddings", "layer_norm_eps",
               "hidden_act")


def test_text_tower_exact_gelu_matches_flax():
    """A two-layer tower with ``hidden_act="gelu"`` against transformers'
    ``FlaxCLIPTextModel`` (exact erf, as flax lowers it); the same weights
    under quick_gelu give another state, so the activation is in play."""
    text = {k: v for k, v in TEXT2.items() if k != "hidden_act"}
    flax_model = FlaxCLIPTextModel(HFTextConfig(vocab_size=ttext.VOCAB,
                                                max_position_embeddings=77,
                                                hidden_act="gelu", **text), seed=4)
    state = state_from_flax(jax.tree_util.tree_map(np.asarray, flax_model.params))
    port = ttext.CLIPTextModel(ttext.CLIPTextConfig(**TEXT2))
    port.load_state_dict(state)
    ids = jtext.HashTokenizer()(PROMPTS[:4])
    want = np.asarray(flax_model(input_ids=ids).last_hidden_state)
    got = ttext.TextEncoder(model=port).encode(PROMPTS[:4]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    quick = ttext.CLIPTextModel(ttext.CLIPTextConfig(**text))
    quick.load_state_dict(state)
    other = ttext.TextEncoder(model=quick).encode(PROMPTS[:4]).numpy()
    assert np.abs(other - want).max() > 1e-3 * np.abs(want).max()
    with pytest.raises(ValueError, match="hidden_act"):
        ttext.CLIPTextModel(ttext.CLIPTextConfig(**dict(TEXT2, hidden_act="tanh")))


@pytest.mark.parametrize("version", ["2.0", "2.1"])
def test_guidance_builds_the_jax_packages_2x_stack(version):
    """``--sd_version 2.0`` and ``2.1`` build (shapes only, on ``meta``)
    the JAX package's ``sd2_unet_config`` UNet and ``_text_config`` tower,
    never the 1.5 config; the VAE is the one of 1.5."""
    g = StableDiffusionGuidance(_port_opt("--sd_version", version), device="meta")
    want_u, want_t = sd2_unet_config(), jtext._text_config(version)
    for f in UNET_FIELDS:
        assert getattr(g.unet.cfg, f) == getattr(want_u, f), f
    tcfg = g.text_encoder.model.text_model.cfg
    for f in TEXT_FIELDS:
        assert getattr(tcfg, f) == getattr(want_t, f), f
    assert sd_family(version) == "2.x" and unet_config(version) != UNetConfig()
    heads = [g.unet.cfg.heads_at(i) for i in range(4)]
    assert [c // h for c, h in zip(g.unet.cfg.block_out_channels, heads)] == [64] * 4
    attn2 = g.unet.get_submodule("mid_block.attentions.0.transformer_blocks.0.attn2")
    assert tuple(attn2.to_k.weight.shape) == (1280, 1024) and attn2.heads == 20
    assert g.param_counts() == {k: FULL_WIDTH_PARAMS["2.x"][k]
                                for k in ("unet", "vae", "text_encoder")}
    # a UNet whose context is not the text tower's width is refused
    with pytest.raises(ValueError, match="1024 wide.*768"):
        StableDiffusionGuidance(_port_opt("--sd_version", version), device="meta",
                                unet_cfg=UNetConfig())


def test_full_width_2x_counts_equal_the_jax_package():
    """The port on ``meta``, the JAX modules through ``jax.eval_shape``."""
    from test_torch_guidance import _jax_count
    key = jax.random.PRNGKey(0)
    jax_counts = {
        "unet": _jax_count(JUNet(sd2_unet_config()).init, key, jnp.zeros((1, 8, 8, 4)),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 1024))),
        "text_encoder": _jax_count(
            lambda k: FlaxCLIPTextModel(jtext._text_config("2.1"), _do_init=False)
            .init_weights(k, (1, 77)), key),
    }
    port_counts = {
        "unet": n_params(build(UNet2DCondition, unet_config("2.1"), device="meta")),
        "text_encoder": n_params(build(ttext.CLIPTextModel, ttext.text_config("2.1"),
                                       device="meta")),
    }
    assert port_counts == jax_counts == {
        "unet": 865_910_724, "text_encoder": 340_387_840}
    assert FULL_WIDTH_PARAMS["2.x"]["vae"] == FULL_WIDTH_PARAMS["1.x"]["vae"]


def test_2x_weights_dir_gives_the_same_eps_and_text_as_jax(tmp_path, capsys):
    """A diffusers 2.x directory (the torch mirror with
    ``use_linear_projection=True``, a Hugging Face text model with exact
    GELU) through the JAX ``load_sd_weights`` and the port's: the linear
    projections land in the 1×1-conv slot, and ε and the text embeddings
    agree."""
    from customnerf_tpu.guidance.weights import load_sd_weights as jload
    from customnerf_torch.guidance.weights import load_sd_weights
    wdir = tcd._weights_dir(tmp_path, SD2)
    src = torch.load(os.path.join(wdir, "unet", "diffusion_pytorch_model.bin"),
                     weights_only=True)
    key = "down_blocks.0.attentions.0.proj_in.weight"
    assert src[key].ndim == 2
    jg, tg = tcd.make_pair(stack=SD2)
    jload(jg, wdir)
    load_sd_weights(tg, wdir)
    out = capsys.readouterr().out
    assert out.count("[INFO] loaded UNet weights") == 2
    assert out.count("loaded text encoder") == 2
    assert torch.equal(tg.unet.state_dict()[key][:, :, 0, 0], src[key])
    got, want = tcd._eps_pair(jg, tg, None, None, stack=SD2)
    close(got, want)
    prompts = PROMPTS[:3]
    close(tg.text_encoder.encode(prompts).numpy(),
          np.asarray(jg.text_encoder.encode(prompts)), 1e-5)


def test_sds_cotangent_matches_jax():
    ju = JUNet(JUNetConfig(**UNET2))
    params = random_params(jax.eval_shape(
        ju.init, jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, CTX2))), 21)
    jopt = JConfig(data_type="synthetic", lambda_sd=0.01, cfg=100.0, sd_version="2.1")
    g = JGuidance.__new__(JGuidance)
    g.opt, g.unet, g.unet_params, g.cd_kv = jopt, ju, params, None
    g.scheduler = jsched.DDPMSchedule()
    g.alphas = g.scheduler.alphas_cumprod
    latents = jax.random.normal(jax.random.PRNGKey(1), (1, 8, 8, 4))
    text = jax.random.normal(jax.random.PRNGKey(2), (2, 7, CTX2))
    key = jax.random.PRNGKey(3)
    loss_fn = g.sds_loss_fn()
    want = jax.jit(jax.grad(lambda l: loss_fn(params, l, text, jnp.int32(300), key)[0]))(
        latents)
    noise = jax.random.normal(key, latents.shape, dtype=latents.dtype)
    tg = StableDiffusionGuidance(
        _port_opt("--sd_version", "2.1"), device="cpu", unet_cfg=UNetConfig(**UNET2),
        vae_cfg=VAEConfig(**VAE_TINY),
        text_encoder=ttext.TextEncoder(model=build(ttext.CLIPTextModel,
                                                   ttext.CLIPTextConfig(**TEXT2))))
    tg.unet.load_state_dict(state_from_flax(params))
    grad, loss = tg.sds_grad(nchw(latents), torch.tensor(np.asarray(text)), 300,
                             nchw(noise))
    close(grad.numpy(), np.asarray(want).transpose(0, 3, 1, 2))
    assert float(loss) == pytest.approx(0.5 * float(jnp.sum(want ** 2)), rel=1e-4)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return ted.make_world(str(tmp_path_factory.mktemp("edit2")),
                          ted.FLAGS + ["--sd_version", "2.1"], UNET2_EDIT, TEXT2)


@pytest.mark.parametrize("branch", ["global", "local"])
def test_editing_step_matches_jax(world2, monkeypatch, branch):
    """One LGIE/SDS editing step under ``--sd_version 2.1`` with the 2.x
    shapes, against the JAX package's pieces (``test_torch_editing.py``)."""
    assert world2["tg"].opt.sd_version == "2.1"
    ted.check_editing_step(world2, monkeypatch, branch, ori_bg=False)


@pytest.mark.parametrize("case", sorted(tcd.TUNE_CASES))
def test_one_tuning_step_matches_jax(tmp_path, monkeypatch, case):
    """The gradients to 1e-4 and the update to 1e-5 as for 1.5, except
    entries whose gradient is under 1e-4 of its tensor's largest (the
    gradient's own tolerance: below it the comparison does not fix the
    sign of Adam's step), held within 2·lr; under 1 % of a tensor."""
    tcd.check_tuning_step(tmp_path, monkeypatch, tcd.TUNE_CASES[case], SD2,
                          grad_floor=1e-4)


def test_artifacts_load_both_ways_at_the_2x_width(tmp_path):
    """``[C, 48]`` K/V adapters and a 48-wide ``<new1>`` row (``[C, 1024]``
    and 1024 at full width) cross both ways."""
    tcd.check_artifacts_both_ways(tmp_path, SD2)


def test_ddim_and_merge_on_the_2x_stack(tmp_path):
    """DDIM class images and ``merge_concepts`` at the 2.x context width."""
    from customnerf_tpu.guidance import custom_diffusion as jcd
    from customnerf_tpu.guidance.sampler import ddim_sample as jddim
    from customnerf_torch.guidance.sampler import ddim_sample
    jg, tg = tcd.make_pair(stack=SD2)
    jtable = tcd.random_table(9, stack=SD2)
    jg.cd_kv = {k: {n: jnp.asarray(v) for n, v in e.items()} for k, e in jtable.items()}
    tg.cd_kv = cd.cd_kv_from_flax(jtable)
    key = jax.random.PRNGKey(4)
    size = tcd.SIZE
    want = np.asarray(jddim(jg, "a photo of a bear", key, num_steps=4, height=size,
                            width=size))
    lat = jax.random.normal(jax.random.split(key)[0], (1, size // 8, size // 8, 4))
    got = ddim_sample(tg, "a photo of a bear", num_steps=4, height=size, width=size,
                      draws=nchw(lat)).numpy()
    close(got, want)

    rs = np.random.RandomState(0)
    base = jcd.extract_cd_kv(jg.unet_params)
    dirs = []
    for i in range(2):
        d = str(tmp_path / f"c{i}")
        table = {k: {n: v + 0.1 * rs.randn(*v.shape).astype(np.float32)
                     for n, v in e.items()} for k, e in base.items()}
        jcd.save_cd_artifacts(d, table, {f"<new{i + 1}>": rs.randn(CTX2).astype(np.float32)})
        dirs.append(d)
    reg = rs.randn(6, CTX2).astype(np.float32)
    cons = [rs.randn(3, CTX2).astype(np.float32) for _ in range(2)]
    want = cd.cd_kv_from_flax(jcd.merge_concepts(dirs, base, reg, cons, steps=5, lr=1e-2))
    got = cd.merge_concepts(dirs, cd.cd_kv_from_flax(base), reg, cons, steps=5, lr=1e-2)
    for k in want:
        for n in ("to_k", "to_v"):
            w = want[k][n].numpy()
            assert w.shape[1] == CTX2
            np.testing.assert_allclose(got[k][n].numpy(), w, rtol=0,
                                       atol=1e-5 * np.abs(w).max())


def test_drill_report_matches_jax(tmp_path, capsys):
    """``--validate_weights --sd_version 2.1`` on the 2.x directory: the
    JAX package's keys, counts and checksums."""
    tcd.check_drill(tmp_path, capsys, SD2, sd_version="2.1")


def test_both_packages_pad_with_eos(tok_dir):
    """Both packages pad to 77 with EOS under 2.x as under 1.5 (the hash
    stand-in and the CLIP BPE); diffusers' SD 2.x tokenizer pads with "!"
    (id 0) instead, a stated deviation of the JAX package (ROADMAP.md)."""
    from customnerf_tpu.guidance import bpe as jbpe
    from customnerf_torch.guidance import bpe as tbpe
    tiny = build(ttext.CLIPTextModel, ttext.CLIPTextConfig(**TEXT2))
    prompts = ["a corgi", "hello world"]
    for port, jax_tok in ((ttext.TextEncoder("2.1", model=tiny).tokenizer,
                           jtext.HashTokenizer()),
                          (tbpe.ClipBPETokenizer.from_dir(tok_dir),
                           jbpe.ClipBPETokenizer.from_dir(tok_dir))):
        got = np.asarray(port(prompts, max_length=77))
        np.testing.assert_array_equal(got, jax_tok(prompts, max_length=77))
        eos = getattr(port, "eos_token_id", ttext.EOS)     # the fixture vocab's own
        for row in got:
            end = int(np.flatnonzero(row == eos)[0])
            assert end >= 2 and (row[end:] == eos).all() and not (row == 0).any()
