"""SDXL base 1.0 as the port's guidance (``--sd_version xl``) against the
plain reference ``benchmark/reference/sdxl.py``, on the CPU with seeded
random weights: the UNet with its text-time conditioning at a small
SDXL-shaped size (three levels, the first without attention, (1, 2, 3)
transformer blocks), the two text towers, the full-width parameter counts
on the meta device (SD 1.x and 2.x held to what they were), a diffusers
SDXL directory loaded back, the refusals, and a tiny ``edit_xl`` cell:
the program's checked steps against ``jobs/edit_xl.py::readings`` under
the cell's limits, with two SDXL faults planted here failing them."""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from types import SimpleNamespace

import pytest
import torch

from benchmark.lib import compare, inputs, registry, training
from benchmark.reference import sd as ref_sd
from benchmark.reference import sdxl as ref_xl
from benchmark.tests import tiny
from customnerf_torch.config import parse_args
from customnerf_torch.guidance.layers import build, n_params
from customnerf_torch.guidance.sds import (FULL_WIDTH_PARAMS, StableDiffusionGuidance,
                                           time_ids)
from customnerf_torch.guidance.text import (CLIPTextConfig, DualTextEncoder, PooledText,
                                            SDXLTextTowers)
from customnerf_torch.guidance.unet import (UNet2DCondition, UNetConfig, sd2_unet_config,
                                            sdxl_unet_config)
from customnerf_torch.guidance.vae import AutoencoderKL, VAEConfig

# SDXL's layout at a CPU's widths: 16-wide heads (64 in SDXL), a
# 16 + 32 context (the two towers), a 24-wide pooled embedding and 8-wide
# time-id embeddings (24 + 6 × 8 = 72 into add_embedding)
UNET = {"in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64, 64],
        "layers_per_block": 2, "cross_attention_dim": 48, "attention_head_dim": [2, 4, 4],
        "norm_num_groups": 8,
        "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"],
        "up_block_types": ["CrossAttnUpBlock2D", "CrossAttnUpBlock2D", "UpBlock2D"],
        "transformer_layers_per_block": [1, 2, 3], "addition_embed_type": "text_time",
        "addition_time_embed_dim": 8, "projection_class_embeddings_input_dim": 72,
        "sample_size": 8}
VAE = dict(tiny.TINY_VAE, scaling_factor=0.13025)
TOWER_1 = CLIPTextConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2,
                         num_attention_heads=2)
TOWER_2 = CLIPTextConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                         num_attention_heads=4, hidden_act="gelu")
POOLED = 24
SEED = 3_000_000_123
CELL = "triplane-sdxl.edit_xl"


def port_unet_config(dtype="float32") -> UNetConfig:
    return UNetConfig(dtype=dtype, **{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in UNET.items() if k != "sample_size"})


def towers() -> DualTextEncoder:
    return DualTextEncoder(model=build(SDXLTextTowers, TOWER_1, TOWER_2, POOLED,
                                       generator=torch.Generator().manual_seed(0)))


def ref_towers(port: DualTextEncoder):
    """The reference's towers holding the port's weights."""
    out = []
    for cfg, proj, m in ((TOWER_1, 0, port.model.text_encoder),
                         (TOWER_2, POOLED, port.model.text_encoder_2)):
        t = ref_xl.TextTower(ref_xl.TextConfig(
            hidden_size=cfg.hidden_size, intermediate_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads, hidden_act=cfg.hidden_act,
            projection_dim=proj))
        t.load_state_dict(m.state_dict())
        out.append(t)
    return out


@pytest.fixture(scope="module")
def unets():
    """The port's UNet and the reference's with the same seeded weights, and
    one input: latents, timesteps, context, pooled embedding, time ids."""
    port = build(UNet2DCondition, port_unet_config())
    ref = ref_sd.build(ref_xl.UNet, ref_xl.unet_config(UNET))
    inputs.fill_sd(port, 1, 5, "cpu")
    inputs.fill_sd(ref, 1, 5, "cpu")
    g = torch.Generator().manual_seed(1)
    args = (torch.randn(2, 4, 8, 8, generator=g), torch.tensor([500, 500]),
            torch.randn(2, 77, 48, generator=g), torch.randn(2, POOLED, generator=g),
            torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2))
    with torch.no_grad():
        want = ref(*args)
    return port, want, args


def _eps(unet, args):
    x, t, ctx, pooled, ids = args
    with torch.no_grad():
        return unet(x, t, ctx, added_cond={"text_embeds": pooled, "time_ids": ids}).float()


def _gap(got, want):
    return float((got - want).norm() / want.norm())


# f32: the same sums in another order (a 1×1 conv against a linear
# projection), some 1e-6 after 40 layers; bf16: 8-bit mantissas at every
# layer's output, some 3e-2 at this size.  Either way far under what one
# missing part of the network moves ε by (0.3-0.5 here).
@pytest.mark.parametrize("dtype, tol", [("float32", 1e-4), ("bfloat16", 0.1)])
def test_unet_matches_the_reference_and_a_missing_part_does_not(unets, dtype, tol):
    port, want, args = unets
    if dtype != "float32":
        low = build(UNet2DCondition, port_unet_config(dtype), device="meta").to_empty(
            device="cpu")
        low.load_state_dict(port.state_dict())
        port = low.to(torch.bfloat16)
    assert _gap(_eps(port, args), want) < tol
    # the text-time embedding dropped
    add = port.add_embedding
    add.forward = lambda cond: torch.zeros(cond.shape[0], add.linear_2.out_features,
                                           dtype=cond.dtype)
    try:
        assert _gap(_eps(port, args), want) > 3 * tol
    finally:
        del add.forward
    # one of level 2's transformer blocks skipped
    blocks = port.down_blocks[2].attentions[0].transformer_blocks
    held = blocks[1]
    del blocks[1]
    try:
        assert _gap(_eps(port, args), want) > 3 * tol
    finally:
        blocks.insert(1, held)


def test_unet_refuses_a_missing_or_stray_text_time_input(unets):
    port, _, (x, t, ctx, pooled, ids) = unets
    with pytest.raises(ValueError, match="added_cond"):
        port(x, t, ctx)
    sd15 = build(UNet2DCondition, UNetConfig(block_out_channels=(32, 64), layers_per_block=1,
                                             cross_attention_dim=48, attention_head_dim=4,
                                             norm_num_groups=8))
    with pytest.raises(ValueError, match="addition_embed_type"):
        sd15(x, t, ctx, added_cond={"text_embeds": pooled, "time_ids": ids})
    assert not hasattr(sd15, "add_embedding")


def test_the_unet_stamps_its_levels_and_the_guidance_build_is_counted(unets):
    """With the tracer on, each level's down and up block, the mid block and
    the text-time embedding are device spans that ``tools/span_split.py``
    reads; the guidance's build is the counter of the trainer's last line."""
    from customnerf_torch.engine import spans
    from tools import span_split
    port, _, args = unets
    spans.enable(True, "cpu")
    spans.reset()
    try:
        _eps(port, args)
        got = spans.collect()
    finally:
        spans.enable(False)
    counts = {k: v["count"] for k, v in got["spans"].items()}
    assert counts == {"unet.level0": 2, "unet.level1": 2, "unet.level2": 2, "unet.mid": 1,
                      "unet.text_time": 1}
    read = span_split.readings("edit_xl", got, 1)
    assert read["unet_graphed_ms"] is None            # no editing step ran
    assert all(read[f"unet_{k}_graphed_ms"] > 0
               for k in ("level0", "level1", "level2", "mid", "text_time"))
    before = dict(spans.counters)
    StableDiffusionGuidance(parse_args(["--sd_version", "xl"]), device="meta")
    assert spans.counters["guidance_build"] == before["guidance_build"] + 1
    assert spans.counters["guidance_build_s"] > before["guidance_build_s"]
    assert f"{spans.counters['guidance_build']} guidance builds" in spans.counters_line(before)


def test_dual_text_towers_match_the_reference():
    """The context is each tower's penultimate state side by side, the
    pooled embedding bigG's projection at the first EOS, and an empty
    negative prompt gives zeros in both (f32 on both sides: to rounding)."""
    port = towers()
    r1, r2 = ref_towers(port)
    prompts, negatives = ["a corgi in a forest", "a bear"], ["", "blurry"]
    got = port.get_text_embeds(prompts, negatives)
    assert isinstance(got, PooledText)
    assert got.context.shape == (4, 77, 48) and got.pooled.shape == (4, POOLED)

    def ids(tok, p):
        return torch.from_numpy(tok(p, max_length=77)).long()
    text = negatives + prompts
    with torch.no_grad():
        ctx, pooled = ref_xl.text_embeds(r1, r2, ids(port.tokenizer, text),
                                         ids(port.tokenizer_2, text),
                                         torch.tensor([True, False, False, False]))
    torch.testing.assert_close(got.context, ctx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got.pooled, pooled, rtol=1e-5, atol=1e-5)
    assert not got.context[0].any() and not got.pooled[0].any()
    assert got.context[1].abs().sum() > 0 and got.pooled[1].abs().sum() > 0


def _keys(module):
    return [(k, tuple(v.shape)) for k, v in module.state_dict().items()]


def test_full_width_counts_and_sd1_sd2_layouts_on_meta():
    """SDXL's UNet as the reference builds it (2,567,463,684 parameters) and
    its two towers; SD 1.5 and 2.x with the keys, shapes and counts of the
    frozen pre-SDXL copy of the port's UNet in ``reference/sd.py``, the SD
    1.5 block types named or not."""
    xl = build(UNet2DCondition, sdxl_unet_config(), device="meta")
    ref = ref_sd.build(ref_xl.UNet, ref_xl.UNetConfig(), device="meta")
    assert n_params(xl) == n_params(ref) == FULL_WIDTH_PARAMS["xl"]["unet"] == 2_567_463_684
    assert sorted(k for k, _ in _keys(xl)) == sorted(k for k, _ in _keys(ref))
    assert n_params(build(SDXLTextTowers, device="meta")) \
        == FULL_WIDTH_PARAMS["xl"]["text_encoder"] == 123_060_480 + 694_659_840
    assert n_params(build(AutoencoderKL, VAEConfig(sample_size=1024, scaling_factor=0.13025),
                          device="meta")) == FULL_WIDTH_PARAMS["xl"]["vae"]
    sd15 = json.load(open(os.path.join(tiny.ROOT, "benchmark", "configs",
                                       "triplane-sd15.json")))["unet"]
    named = UNetConfig(**{k: tuple(v) for k, v in sd15.items() if k.endswith("_types")})
    for family, cfg, frozen in (
            ("1.x", UNetConfig(), ref_sd.UNetConfig()),
            ("1.x", named, ref_sd.UNetConfig()),
            ("2.x", sd2_unet_config(), ref_sd.sd2_unet_config())):
        port = build(UNet2DCondition, cfg, device="meta")
        assert _keys(port) == _keys(ref_sd.build(ref_sd.UNet2DCondition, frozen, device="meta"))
        assert n_params(port) == FULL_WIDTH_PARAMS[family]["unet"]


def test_sd_version_xl_builds_the_sdxl_stack_on_meta():
    opt = parse_args(["--sd_version", "xl", "--allow_random_guidance"])
    g = StableDiffusionGuidance(opt, device="meta")
    assert g.family == "xl" and g.param_counts() == {
        k: v for k, v in FULL_WIDTH_PARAMS["xl"].items() if k != "clip_view"}
    assert g.vae.cfg.sample_size == 1024 and g.vae.cfg.scaling_factor == 0.13025
    assert g.unet.cfg.dtype == "bfloat16" and g.time_ids.shape == (6,)
    assert time_ids(g.vae.cfg.sample_size) == [1024, 1024, 0, 0, 1024, 1024]
    assert next(g.text_encoder.model.parameters()).dtype == torch.float32
    assert StableDiffusionGuidance(parse_args([]), device="meta").time_ids is None


def test_xl_refuses_custom_diffusion_and_scenes(tmp_path):
    from customnerf_torch.engine.editing import editing_step_scenes
    from customnerf_torch.guidance.custom_diffusion import train_custom_diffusion
    opt = parse_args(["--sd_version", "xl", "--use_cd", str(tmp_path)])
    with pytest.raises(ValueError, match="xl does not support --use_cd"):
        StableDiffusionGuidance(opt, device="meta")
    g = StableDiffusionGuidance(parse_args(["--sd_version", "xl"]), device="meta")
    with pytest.raises(ValueError, match="xl does not support --use_cd"):
        g.load_cd(str(tmp_path))
    trainer = SimpleNamespace(opt=g.opt, device=torch.device("cpu"), guidance=g)
    with pytest.raises(ValueError, match="xl does not support multi-scene"):
        editing_step_scenes(trainer, [], {}, {})
    with pytest.raises(ValueError, match="xl does not support Custom Diffusion"):
        train_custom_diffusion(g.opt, str(tmp_path), "a bear", str(tmp_path))


def _tokenizer_dir(path):
    """A CLIP BPE directory: the byte alphabet and its </w> forms, two merges
    and the specials."""
    from customnerf_torch.guidance.bpe import bytes_to_unicode
    alphabet = list(bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(alphabet)}
    vocab.update({ch + "</w>": len(alphabet) + i for i, ch in enumerate(alphabet)})
    vocab.update({"be": len(vocab), "<|startoftext|>": len(vocab) + 1,
                  "<|endoftext|>": len(vocab) + 2})
    os.makedirs(path)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\nb e\n")


def test_an_sdxl_diffusers_directory_loads(tmp_path):
    """A tiny SDXL base directory written here (the reference's UNet with
    diffusers' linear ``proj_in``/``proj_out``, a VAE, both towers and both
    tokenizers) loads into the port: ε equals the reference's, the towers
    and the VAE hold the files' weights, each tokenizer is the BPE."""
    from customnerf_torch.guidance.bpe import ClipBPETokenizer
    ref = ref_sd.build(ref_xl.UNet, ref_xl.unet_config(UNET))
    inputs.fill_sd(ref, 2, 5, "cpu")
    vae = build(AutoencoderKL, VAEConfig(**{k: tuple(v) if isinstance(v, list) else v
                                            for k, v in VAE.items()}),
                generator=torch.Generator().manual_seed(3))
    src = towers()
    for sub, state, name in (
            ("unet", ref.state_dict(), "diffusion_pytorch_model.bin"),
            ("vae", vae.state_dict(), "diffusion_pytorch_model.bin"),
            ("text_encoder", src.model.text_encoder.state_dict(), "pytorch_model.bin"),
            ("text_encoder_2", src.model.text_encoder_2.state_dict(), "pytorch_model.bin")):
        os.makedirs(tmp_path / sub)
        torch.save(state, tmp_path / sub / name)
    for sub in ("tokenizer", "tokenizer_2"):
        _tokenizer_dir(tmp_path / sub)
    assert ref.down_blocks[1].attentions[0].proj_in.weight.ndim == 2
    opt = parse_args(["--sd_version", "xl", "--sd_weights", str(tmp_path)])
    text = DualTextEncoder(weights_dir=str(tmp_path), model=towers().model)
    assert isinstance(text.tokenizer, ClipBPETokenizer)
    assert isinstance(text.tokenizer_2, ClipBPETokenizer)
    g = StableDiffusionGuidance(opt, device="cpu", unet_cfg=port_unet_config(),
                                vae_cfg=VAEConfig(**{k: tuple(v) if isinstance(v, list)
                                                     else v for k, v in VAE.items()}),
                                text_encoder=text)
    for a, b in ((g.text_encoder.model, src.model), (g.vae, vae)):
        for (k, v), (k2, w) in zip(a.state_dict().items(), b.state_dict().items()):
            assert k == k2 and torch.equal(v, w), k
    g_ = torch.Generator().manual_seed(4)
    x, ctx = torch.randn(2, 4, 8, 8, generator=g_), torch.randn(2, 77, 48, generator=g_)
    pooled = torch.randn(2, POOLED, generator=g_)
    t = torch.tensor([300, 300])
    with torch.no_grad():
        got = g.unet(x, t, ctx, added_cond=g.added_cond(pooled))
        want = ref(x, t, ctx, pooled, g.time_ids.expand(2, 6))
    assert _gap(got, want) < 1e-4


# ------------------------------------------------------------ the tiny cell
def _cell():
    """``triplane-sdxl.edit_xl`` at a CPU's widths (``benchmark/tests/tiny.py``'s
    editing cell with this file's UNet and VAE, two views, two checked steps),
    the field's heads in f32 (``--backend pallas``) so that the program
    follows the reference to rounding."""
    cfg = copy.deepcopy(registry.config(tiny.bench(), "triplane-sdxl", tiny.ROOT))
    cfg.update(triplane_res=[16, 32], triplane_channels=[8, 4], occ_grid_size=16,
               max_ray_batch=128, unet=UNET, vae=VAE, backend="pallas",
               keep_bg=cfg["keep_bg"] * 16 * 16 / (128 * 128))
    traffic = dict(registry.traffic("edit_xl"), views=2, H=16, W=16, epoch_steps=2,
                   checked_steps=2, occupancy_warmup=2, steps_per_dispatch=1)
    return cfg, traffic


def _zero_pooled(guidance):
    base = guidance.added_cond

    def zeroed(pooled):
        return base(torch.zeros_like(pooled))
    guidance.added_cond = zeroed


def _skip_a_level2_block(guidance):
    del guidance.unet.down_blocks[2].attentions[0].transformer_blocks[1]


@pytest.mark.parametrize("fault", [None, _zero_pooled, _skip_a_level2_block])
def test_tiny_edit_xl_cell_is_correct_and_planted_faults_are_not(fault):
    """The program's checked steps (``Trainer.train_one_epoch`` through
    ``editing_steps_many``) against ``jobs/edit_xl.py::readings`` under the
    cell's limits: correct as it is, not with the pooled embedding zeroed in
    the program or with one level-2 transformer block skipped."""
    cfg, traffic = _cell()
    job = registry.job(traffic["job"])
    prog = training.build(job, cfg, traffic, SEED, "unused", "cpu",
                          guidance_kw={"text_encoder": towers()})
    if fault is not None:
        fault(prog.trainer.guidance)
    got = training.checked_steps(job, prog, traffic, training.initial_field(cfg, SEED, "cpu"))
    assert isinstance(prog.trainer.text_z, PooledText)
    training.free(prog)
    numbers = compare.gaps(got, job.readings(cfg, traffic, SEED, "cpu", follow=got))
    assert compare.judge(numbers, registry.limits(CELL)) is (fault is None), numbers
    if fault is None:
        # as benchmark/tests' editing cell with f32 heads: the tri-plane table
        # gradient keeps its bf16 operands, a few 1e-3 after Adam's steps
        assert max(v for k, v in numbers.items() if k.endswith("_gap")) < 2e-2, numbers


def test_the_trainer_embeds_its_prompts_with_both_towers():
    """Without handed-over embeddings the trainer embeds its prompts itself
    (``prepare_text_embeddings``): each ``text_z*`` a ``PooledText`` of the
    towers, carried through the LGIE gate into the step."""
    cfg, traffic = _cell()
    job = registry.job(traffic["job"])
    prog = training.build(job, cfg, traffic, SEED, "unused", "cpu",
                          guidance_kw={"text_encoder": towers()})
    tr = prog.trainer
    for name in ("text_z", "text_z_fg", "text_z_norm", "text_z_norm_fg", "text_z_bg"):
        delattr(tr, name)
    loss = tr.train_one_epoch(prog.take(2))
    assert isinstance(tr.text_z, PooledText) and isinstance(tr.text_z_bg, PooledText)
    assert tr.text_z.context.shape == (2, 77, 48) and tr.text_z.pooled.shape == (2, POOLED)
    # the negative prompt (--negative "") embeds as zeros
    assert not tr.text_z.context[0].any() and not tr.text_z.pooled[0].any()
    assert loss == loss and loss > 0
    training.free(prog)


def test_the_cells_work_is_counted_from_the_sdxl_shapes():
    cfg, traffic = _cell()
    job = registry.job("edit_xl")
    per_step, _, model = training.work(job, cfg, traffic, 0.5)
    assert set(per_step) == {"k1", "dt", "unet"} and model > per_step["unet"][0][0] > 0
    c = job.sdxl_counts(cfg)
    assert c["vae_backward"][0] > c["vae_forward"][0] > 0
    full = registry.config(tiny.bench(), "triplane-sdxl", tiny.ROOT)
    assert job.pooled_width(full["unet"]) == 1280 and job.time_ids(full) == [
        1024, 1024, 0, 0, 1024, 1024]
    assert dataclasses.asdict(ref_xl.unet_config(full["unet"])) == dataclasses.asdict(
        ref_xl.UNetConfig())
