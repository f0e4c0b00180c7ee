"""FLUX.1-dev as the port's guidance (``--sd_version flux-dev``) against the
plain reference ``benchmark/reference/flux.py``, on the CPU with seeded
random weights: a tiny FLUX (2 double and 2 single blocks, 2 heads of 32,
rotary axes (4, 14, 14)) in f32 and bf16, a tiny T5 with its
relative-position bias, RoPE's pair rotation by hand, the flow SDS gradient
and the σ shift against their formulas, the full-width counts on the meta
device (SD 1.x, 2.x and XL held to what they were), the refusals, the
``dit`` spans, and a tiny ``edit_flux`` cell: the program's checked steps
against ``jobs/edit_flux.py::readings`` under the cell's limits, with the
planted faults of ``tools/flux_faults.py`` failing them."""

from __future__ import annotations

import copy
import math
from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import compare, registry, training
from benchmark.reference import flux as rf
from benchmark.reference import sd as ref_sd
from benchmark.tests import tiny
from customnerf_torch.config import parse_args
from customnerf_torch.guidance import flux, sds
from customnerf_torch.guidance.flux import FluxConfig, FluxTransformer
from customnerf_torch.guidance.layers import build, n_params
from customnerf_torch.guidance.sds import FULL_WIDTH_PARAMS, StableDiffusionGuidance
from customnerf_torch.guidance.text import (CLIPTextConfig, FluxTextEncoder, FluxTextTowers,
                                            PooledText, T5Config, T5EncoderModel,
                                            flux_text_towers)
from customnerf_torch.guidance.vae import AutoencoderKL, VAEConfig
from tools import flux_faults

CELL = "triplane-flux.edit_flux"
SEED = 3_000_000_123
# FLUX's layout at a CPU's widths: 2 heads of 32 (24 of 128), a 48-wide
# context (T5's 4096) of 12 tokens (512), a 24-wide pooled embedding (768)
TINY = {"in_channels": 64, "out_channels": None, "patch_size": 1, "num_layers": 2,
        "num_single_layers": 2, "attention_head_dim": 32, "num_attention_heads": 2,
        "joint_attention_dim": 48, "pooled_projection_dim": 24, "guidance_embeds": True,
        "axes_dims_rope": [4, 14, 14],
        "pipeline": {"guidance_scale": 3.5, "max_sequence_length": 12}}
VAE = dict(tiny.TINY_VAE, latent_channels=16, scaling_factor=0.3611, shift_factor=0.1159,
           use_quant_conv=False, use_post_quant_conv=False)
CLIP = CLIPTextConfig(hidden_size=24, intermediate_size=48, num_hidden_layers=2,
                      num_attention_heads=2)
T5 = T5Config(vocab_size=300, d_model=48, d_kv=8, d_ff=64, num_layers=3, num_heads=6,
              relative_attention_num_buckets=8, relative_attention_max_distance=16,
              max_length=12)


def port_config(dtype="float32") -> FluxConfig:
    names = set(FluxConfig.__dataclass_fields__)
    return FluxConfig(dtype=dtype, **{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in TINY.items() if k in names})


def vae_config() -> VAEConfig:
    return VAEConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in VAE.items()})


def towers() -> FluxTextEncoder:
    return FluxTextEncoder(model=flux_text_towers(generator=torch.Generator().manual_seed(0),
                                                  clip_cfg=CLIP, t5_cfg=T5))


def _gap(got, want):
    return float((got - want).norm() / want.norm())


@pytest.fixture(scope="module")
def models():
    """The port's transformer and the reference's with the same draws, and
    one input: latents, σ, context, pooled embedding, guidance."""
    port = build(FluxTransformer, port_config())
    rf.fill(port, 1, 5, "cpu")
    ref = ref_sd.build(rf.Flux, rf.flux_params(TINY))
    rf.fill(ref, 1, 5, "cpu")
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(2, 16, 8, 8, generator=g), torch.tensor([0.3, 0.8]),
            torch.randn(2, 12, 48, generator=g), torch.randn(2, 24, generator=g),
            torch.tensor([3.5, 3.5]))
    with torch.no_grad():
        want = rf.velocity(ref, *args)
    return port, want, args


def _velocity(model, args):
    with torch.no_grad():
        return model(*args).float()


# f32: the same sums in another order, some 1e-7; bf16: 8-bit mantissas at
# every layer's output, some 1e-2 at this size
BF16_TOL = 0.04


@pytest.mark.parametrize("dtype, tol", [("float32", 1e-5), ("bfloat16", BF16_TOL)])
def test_transformer_matches_the_reference(models, dtype, tol):
    port, want, args = models
    if dtype != "float32":
        low = build(FluxTransformer, port_config(dtype), dtype=torch.bfloat16)
        low.load_state_dict(port.state_dict())
        port = low
    assert _gap(_velocity(port, args), want) < tol


@pytest.mark.parametrize("name", [n for n in flux_faults.NAMES
                                  if n not in ("sigma_unshifted", "transformer_fp8")])
def test_a_missing_part_of_the_transformer_moves_it_past_bf16s_rounding(models, name):
    """Each of ``tools/flux_faults.py``'s faults inside the transformer moves
    v̂ by more than bf16's rounding does (at this size: positions of at most
    3 turn RoPE's slow pairs little, so dropping it moves v̂ least)."""
    port, want, args = models
    if name in flux_faults.ON_GUIDANCE:
        port = copy.deepcopy(port)
        flux_faults.ON_GUIDANCE[name](SimpleNamespace(unet=port))
        got = _velocity(port, args)
    else:
        with flux_faults.planted(name):
            got = _velocity(port, args)
    assert _gap(got, want) > BF16_TOL, name


def test_rope_rotates_adjacent_pairs_by_each_axis():
    """Pair k of axis a turns by id_a·θ^(−2k/d_a): (x₂ₖ, x₂ₖ₊₁) →
    (x₂ₖ cos − x₂ₖ₊₁ sin, x₂ₖ sin + x₂ₖ₊₁ cos), against a hand loop and the
    reference's table."""
    axes, theta = (4, 14, 14), 10_000
    ids = flux.position_ids(3, 4, 6, "cpu")
    assert ids.shape == (3 + 2 * 3, 3) and not ids[:3].any()
    assert ids[3 + 4].tolist() == [0.0, 1.0, 1.0]           # patch (1, 1)
    table = flux.rope_table(ids, axes, theta)
    torch.testing.assert_close(table, rf.EmbedND(32, theta, axes)(ids[None])[0, 0])
    x = torch.randn(1, ids.shape[0], 2, 32, generator=torch.Generator().manual_seed(0))
    got = flux.apply_rope(x, table)
    want = torch.empty_like(x)
    for pos in range(ids.shape[0]):
        ch = 0
        for a, d in enumerate(axes):
            for k in range(d // 2):
                ang = float(ids[pos, a]) * theta ** (-2 * k / d)
                c, s = math.cos(ang), math.sin(ang)
                x0, x1 = x[0, pos, :, ch], x[0, pos, :, ch + 1]
                want[0, pos, :, ch], want[0, pos, :, ch + 1] = x0 * c - x1 * s, x0 * s + x1 * c
                ch += 2
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[:, :3], x[:, :3])        # text tokens sit at 0


def test_t5_with_its_relative_position_bias_matches_the_reference():
    port = build(T5EncoderModel, T5, generator=torch.Generator().manual_seed(2))
    bias = port.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
    with torch.no_grad():       # a bias as large as the logits, so that it shows
        bias.normal_(generator=torch.Generator().manual_seed(4))
    ref = ref_sd.build(rf.T5EncoderModel, rf.T5Config(**{k: getattr(T5, k) for k in
                                                      rf.T5Config.__dataclass_fields__}))
    ref.load_state_dict(port.state_dict())
    ids = torch.randint(0, T5.vocab_size, (2, 20), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        got, want = port(ids), ref(ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # the bias depends on the offset alone, with a sign; the far offsets share buckets
    b = port.encoder.block[0].layer[0].SelfAttention.position_bias(20, "cpu")[0, 0]
    assert torch.equal(b.diagonal(3), b[0, 3].expand(17)) and b[0, 3] != b[3, 0]
    assert b[0, 19] == b[0, 18]
    with torch.no_grad():
        ref.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight.zero_()
        assert _gap(port(ids), ref(ids)) > 0.05
    tok = FluxTextEncoder(model=flux_text_towers(clip_cfg=CLIP, t5_cfg=T5)).tokenizer_2
    row = tok(["a corgi in a forest"])[0]
    assert row.shape == (12,) and row[5] == 1 and not row[6:].any() and (row[:5] > 2).all()


def test_the_text_pair_gives_t5s_context_and_clips_pooled_state():
    enc = towers()
    got = enc.get_text_embeds(["a corgi", "a bear in the snow"], ["ignored", "too"])
    assert isinstance(got, PooledText)
    assert got.context.shape == (2, 12, 48) and got.pooled.shape == (2, 24)
    assert got.context.dtype == got.pooled.dtype == torch.float32
    with torch.no_grad():
        ids = torch.from_numpy(enc.tokenizer_2(["a corgi"]))
        torch.testing.assert_close(got.context[:1], enc.model.text_encoder_2(ids))
    assert enc.width == 48


def test_flow_sds_gradient_and_the_sigma_shift_follow_their_formulas(models):
    """σ = e^μ/(e^μ + 1/σ₀ − 1) with μ 1.15 at 4,096 tokens (0.5 at 256);
    grad = w(σ)·(x_σ + (1 − σ)·v̂ − ε)·λ_sd, w = σ²/((1 − σ)² + σ²)."""
    t = torch.tensor([20, 500, 980])
    for tokens, mu in ((4096, 1.15), (256, 0.5)):
        s0 = t.double() / 1000
        want = math.exp(mu) / (math.exp(mu) + 1 / s0 - 1)
        torch.testing.assert_close(sds.flow_sigma(t, tokens).double(), want, rtol=1e-6, atol=0)
        torch.testing.assert_close(rf.sigma_of(t, tokens).double(), want, rtol=1e-6, atol=0)
    assert rf.time_shift_mu(4096) == pytest.approx(1.15)
    port, _, args = models
    opt = parse_args(["--sd_version", "flux-dev", "--lambda_sd", "0.01"])
    g = SimpleNamespace(unet=port, opt=opt, flux_guidance=torch.tensor([3.5]))
    x0, ctx, pooled = args[0][:1], args[2][:1], args[3][:1]
    noise = torch.randn(x0.shape, generator=torch.Generator().manual_seed(5))
    t = torch.tensor([700])
    grad, loss = StableDiffusionGuidance.flow_grad_batch(g, x0, ctx, t, noise, pooled)
    s = float(sds.flow_sigma(t, 16))
    xs = (1 - s) * x0 + s * noise
    with torch.no_grad():
        v = port(xs, torch.tensor([s]), ctx, pooled, torch.tensor([3.5]))
    want = s * s / ((1 - s) ** 2 + s * s) * (xs + (1 - s) * v - noise) * 0.01
    torch.testing.assert_close(grad, want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(loss, 0.5 * (want ** 2).sum()[None])
    ref_grad, _ = rf.sds_grad(ref_sd.build(rf.Flux, rf.flux_params(TINY), device="meta"), x0,
                              noise, t, ctx, pooled, 3.5, 0.01, rf.streamed(1, 5, "cpu"))
    assert _gap(grad, ref_grad) < 1e-5


def _keys(module):
    return sorted((k, tuple(v.shape)) for k, v in module.state_dict().items())


def test_full_width_counts_and_the_sd_layouts_on_meta():
    """The transformer 11,901,408,320 and T5's encoder 4,762,310,656, the
    reference's keys and counts; the SD VAEs keep their keys and counts
    with the new options at their defaults."""
    port = build(FluxTransformer, device="meta")
    ref = ref_sd.build(rf.Flux, device="meta")
    assert n_params(port) == n_params(ref) == FULL_WIDTH_PARAMS["flux"]["unet"] \
        == 11_901_408_320 == 19 * 339_831_296 + 38 * 141_591_808 + 64_124_992
    assert _keys(port) == _keys(ref)
    t5 = build(T5EncoderModel, device="meta")
    assert n_params(t5) == n_params(ref_sd.build(rf.T5EncoderModel, device="meta")) \
        == 4_762_310_656
    assert _keys(t5) == _keys(ref_sd.build(rf.T5EncoderModel, device="meta"))
    assert n_params(build(FluxTextTowers, device="meta")) \
        == FULL_WIDTH_PARAMS["flux"]["text_encoder"] == 4_762_310_656 + 123_060_480
    fv = sds.vae_config("flux-dev")
    vae = build(AutoencoderKL, fv, device="meta")
    ref_vae = ref_sd.build(rf.VAE, rf.vae_config(registry.config(
        tiny.bench(), "triplane-flux", tiny.ROOT)["vae"]), 0.1159, device="meta")
    assert n_params(vae) == n_params(ref_vae) == FULL_WIDTH_PARAMS["flux"]["vae"]
    assert _keys(vae) == _keys(ref_vae)
    for version in ("1.5", "2.1", "xl"):
        got = build(AutoencoderKL, sds.vae_config(version), device="meta")
        want = ref_sd.build(ref_sd.AutoencoderKL, ref_sd.VAEConfig(), device="meta")
        assert _keys(got) == _keys(want) and n_params(got) == 83_653_863


def test_the_configuration_is_the_ports_published_flux():
    cfg = registry.config(tiny.bench(), "triplane-flux", tiny.ROOT)
    u, v = cfg["unet"], cfg["vae"]
    names = set(FluxConfig.__dataclass_fields__)
    assert FluxConfig(**{k: tuple(x) if isinstance(x, list) else x
                         for k, x in u.items() if k in names}) == FluxConfig()
    assert rf.flux_params(u) == rf.FluxParams()
    want = sds.vae_config("flux-dev")
    assert all(getattr(want, k) == (tuple(x) if isinstance(x, list) else x)
               for k, x in v.items())
    assert u["pipeline"] == {"guidance_scale": sds.FLUX_GUIDANCE,
                             "max_sequence_length": T5Config().max_length}
    sch = u["scheduler"]
    assert sds.FLUX_SHIFT == rf.SHIFT == ((sch["base_image_seq_len"], sch["base_shift"]),
                                          (sch["max_image_seq_len"], sch["max_shift"]))
    t5 = u["text_encoder_2"]
    assert all(getattr(T5Config(), k) == x for k, x in t5.items()
               if k in T5Config.__dataclass_fields__)
    assert rf.t5_config(t5) == rf.T5Config()
    assert cfg["parameters"] == {"transformer": 11_901_408_320, "vae": 83_819_683,
                                 "t5_encoder": 4_762_310_656, "clip_l_text": 123_060_480}


def test_sd_version_flux_dev_builds_the_stack_on_meta_in_bf16():
    g = StableDiffusionGuidance(parse_args(["--sd_version", "flux-dev",
                                            "--allow_random_guidance"]), device="meta")
    assert g.family == "flux" and g.span == "dit" and g.time_ids is None
    assert g.param_counts() == {k: v for k, v in FULL_WIDTH_PARAMS["flux"].items()
                                if k != "clip_view"}
    assert g.unet.cfg.dtype == "bfloat16" and g.vae.cfg.latent_channels == 16
    assert next(g.unet.parameters()).dtype == torch.bfloat16
    assert next(g.text_encoder.model.text_encoder_2.parameters()).dtype == torch.bfloat16
    assert next(g.text_encoder.model.text_encoder.parameters()).dtype == torch.float32
    assert g.vae.cfg.shift_factor == 0.1159 and not hasattr(g.vae, "quant_conv")
    assert StableDiffusionGuidance(parse_args([]), device="meta").span == "unet"


def test_flux_refuses_custom_diffusion_scenes_tuning_and_weights(tmp_path):
    from customnerf_torch.engine.editing import editing_step_scenes
    from customnerf_torch.guidance.custom_diffusion import train_custom_diffusion
    with pytest.raises(ValueError, match="flux-dev does not support --use_cd"):
        StableDiffusionGuidance(parse_args(["--sd_version", "flux-dev", "--use_cd",
                                            str(tmp_path)]), device="meta")
    with pytest.raises(NotImplementedError, match="the loader waits"):
        StableDiffusionGuidance(parse_args(["--sd_version", "flux-dev", "--sd_weights",
                                            str(tmp_path)]), device="meta")
    g = StableDiffusionGuidance(parse_args(["--sd_version", "flux-dev"]), device="meta")
    with pytest.raises(ValueError, match="flux-dev does not support --use_cd"):
        g.load_cd(str(tmp_path))
    trainer = SimpleNamespace(opt=g.opt, device=torch.device("cpu"), guidance=g)
    with pytest.raises(ValueError, match="flux-dev does not support multi-scene"):
        editing_step_scenes(trainer, [], {}, {})
    with pytest.raises(ValueError, match="flux-dev does not support Custom Diffusion"):
        train_custom_diffusion(g.opt, str(tmp_path), "a bear", str(tmp_path))
    # SDXL's messages as they were
    xl = parse_args(["--sd_version", "xl", "--use_cd", str(tmp_path)])
    with pytest.raises(ValueError, match="--sd_version xl does not support --use_cd"):
        StableDiffusionGuidance(xl, device="meta")


def test_the_transformer_stamps_its_spans(models):
    """With the tracer on the call is ``dit.embed``, ``dit.double`` and
    ``dit.single``; ``tools/span_split.py`` reads them under ``edit_flux``."""
    from customnerf_torch.engine import spans
    from tools import span_split
    port, _, args = models
    spans.enable(True, "cpu")
    spans.reset()
    try:
        _velocity(port, args)
        got = spans.collect()
    finally:
        spans.enable(False)
    assert {k: v["count"] for k, v in got["spans"].items()} == {
        "dit.embed": 1, "dit.double": 1, "dit.single": 1}
    read = span_split.readings("edit_flux", got, 1)
    assert read["dit_graphed_ms"] is None            # no editing step ran
    assert all(read[f"dit_{k}_graphed_ms"] > 0 for k in ("embed", "double", "single"))


# ------------------------------------------------------------ the tiny cell
def _cell():
    """``triplane-flux.edit_flux`` at a CPU's widths (``benchmark/tests/tiny.py``'s
    editing cell with this file's transformer and VAE, two views, one checked
    step: every number the cell's limits read comes from the first), the
    field's heads in f32 (``--backend pallas``)."""
    cfg = copy.deepcopy(registry.config(tiny.bench(), "triplane-flux", tiny.ROOT))
    cfg.update(triplane_res=[16, 32], triplane_channels=[8, 4], occ_grid_size=16,
               max_ray_batch=128, unet=TINY, vae=VAE, backend="pallas",
               keep_bg=cfg["keep_bg"] * 16 * 16 / (128 * 128))
    traffic = dict(registry.traffic("edit_flux"), views=2, H=16, W=16, epoch_steps=2,
                   checked_steps=1, occupancy_warmup=2, steps_per_dispatch=1)
    return cfg, traffic


def _tiny_job():
    job = registry.job("edit_flux")

    def build_guidance(trainer):
        return StableDiffusionGuidance(trainer.opt, device=trainer.device,
                                       unet_cfg=port_config(), vae_cfg=vae_config(),
                                       text_encoder=towers())
    job.build_guidance = build_guidance
    return job


# (the SDS-scaled fault is read where the first step is local and its SDS
# part leads the keep_bg part: no seed of this size does, so the card's
# calibration alone holds it)
@pytest.mark.parametrize("fault", [None, *flux_faults.NAMES, "half_batch"])
def test_tiny_edit_flux_cell_is_correct_and_planted_faults_are_not(fault):
    """The program's checked steps (``Trainer.train_one_epoch`` through
    ``editing_steps_many``) against ``jobs/edit_flux.py::readings`` under the
    cell's limits: correct as it is, not with a fault planted."""
    cfg, traffic = _cell()
    job = _tiny_job()
    plant = (training.fault(fault) if fault in ("half_batch", "sds_scaled") else
             flux_faults.planted(fault) if fault else training.fault(None))
    seed = SEED
    prog = training.build(job, cfg, traffic, seed, "unused", "cpu")
    with plant:
        got = training.checked_steps(job, prog, traffic,
                                     training.initial_field(cfg, seed, "cpu"))
    tr = prog.trainer
    assert isinstance(tr.text_z, PooledText) and tr.text_z.context.shape == (1, 12, 48)
    assert got["cot"].shape == (1, 16, 8, 8)
    training.free(prog)
    numbers = compare.gaps(got, job.readings(cfg, traffic, seed, "cpu", follow=got))
    assert compare.judge(numbers, registry.limits(CELL)) is (fault is None), numbers
    if fault is None:
        assert max(v for k, v in numbers.items() if k.endswith("_gap")) < 2e-2, numbers


def test_the_trainer_embeds_its_prompts_with_t5_and_clip():
    """Without handed-over embeddings the trainer embeds its prompts itself
    (``prepare_text_embeddings``): each ``text_z*`` a ``PooledText`` of T5's
    context and CLIP-L's pooled state, through the LGIE gate into the step."""
    cfg, traffic = _cell()
    job = _tiny_job()
    prog = training.build(job, cfg, traffic, SEED, "unused", "cpu")
    tr = prog.trainer
    tr.guidance = job.build_guidance(tr)
    loss = tr.train_one_epoch(prog.take(1))
    assert isinstance(tr.text_z, PooledText) and tr.text_z.context.shape == (1, 12, 48)
    assert tr.text_z.pooled.shape == (1, 24) and loss == loss and loss > 0
    training.free(prog)


def test_the_cells_work_is_counted_from_the_flux_shapes():
    cfg, traffic = _cell()
    job = registry.job("edit_flux")
    per_step, _, model = training.work(job, cfg, traffic, 0.5)
    assert set(per_step) == {"k1", "dt", "unet"} and model > per_step["unet"][0][0] > 0
    c = job.flux_counts(cfg)
    assert c["vae_backward"][0] > c["vae_forward"][0] > 0
    # the joint attention by hand: 4·L²·D a block, L = 16 image + 12 text tokens
    attn = (2 + 2) * 4 * 28 ** 2 * 64
    linear = job.flux_counts(dict(cfg, unet=dict(TINY, num_layers=0, num_single_layers=0)))
    blocks = c["dit"][0] - linear["dit"][0]
    assert blocks == pytest.approx(attn + 2 * 28 * (2 * 12 + 2 * 12) * 64 * 64, rel=0.2)
