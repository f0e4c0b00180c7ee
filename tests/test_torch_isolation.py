"""The port stands alone: ``customnerf_torch``, ``chip_smoke.py`` and the
study tools in ``tools/`` import nothing of JAX, nothing of the JAX package,
and none of ``transformers``, ``safetensors``, ``cv2``, PIL, ``orbax``,
``tensorstore`` or ``zstandard`` (the card's machine may lack them; the
image, data, checkpoint and guidance paths decode and resize on their own),
the host library has no Python fallback (without a compiler a JPEG read
raises, naming it), and the entry points run on the card unless the caller
asks for the CPU.  Plus tiny end-to-end runs on the CPU (control flow, not
speed): the trainer loop, the CLI on a nerfstudio fixture then ``--test``,
and phase 1 → checkpoint → phase 2 (editing), on the ``-O`` tri-plane path
and on ``bear.sh --parity``'s ``-O2`` grid path."""

import math
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from test_torch_guidance import one_thread  # noqa: E402,F401

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "transformers", "safetensors",
             "cv2", "PIL", "orbax", "tensorstore", "zstandard"):
    sys.modules[name] = None          # any import of them now fails
import customnerf_torch
mods = [m.name for m in pkgutil.walk_packages(customnerf_torch.__path__,
                                              "customnerf_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import tools.device_probe, tools.kernel_study
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("customnerf_tpu", "jax", "jaxlib", "flax", "optax", "transformers",
              "safetensors", "cv2", "PIL", "orbax", "tensorstore", "zstandard")
             and sys.modules[m] is not None)
assert {"customnerf_torch.utils.png", "customnerf_torch.utils.resample",
        "customnerf_torch.data.nerfstudio", "customnerf_torch.data.llff",
        "customnerf_torch.data.dtu", "customnerf_torch.data.fixtures",
        "customnerf_torch.ops.grid", "customnerf_torch.ops.morton",
        "customnerf_torch.ops.regularizers",
        "customnerf_torch.engine.torch_shim", "customnerf_torch.utils.jpeg",
        "customnerf_torch.guidance.custom_diffusion", "customnerf_torch.guidance.sampler",
        "customnerf_torch.guidance.retrieve", "customnerf_torch.guidance.validate",
        "customnerf_torch.tune_custom_diffusion", "customnerf_torch.parallel",
        "customnerf_torch.parallel.mesh", "customnerf_torch.engine.ocdbt",
        "customnerf_torch.engine.pytreedef", "customnerf_torch.engine.checkpoint",
        "customnerf_torch.utils.zstd", "customnerf_torch.utils.hostlib",
        "customnerf_torch.utils.image"} <= set(mods)
assert not bad, bad
print("imported", len(mods))
"""


def _run(args, cwd=REPO, **kw):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_and_chip_smoke_import_no_jax():
    r = _run(["-c", _IMPORT_ALL])
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 30


def test_chip_smoke_fails_without_a_card(tmp_path):
    r = _run([os.path.join(REPO, "chip_smoke.py")])
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    # alone in a directory, without the package beside it
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(os.path.join(REPO, "chip_smoke.py")).read())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    r = subprocess.run([sys.executable, str(alone)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok": true' not in r.stdout


def test_host_library_without_a_compiler_raises_naming_it(tmp_path):
    """No Python fallback on the read path: with ``$CXX`` naming no compiler,
    the first JPEG read raises ``RuntimeError`` naming it; so does a zstd
    decode."""
    from customnerf_torch.utils import jpeg
    path = jpeg.write_jpeg(str(tmp_path / "x.jpg"),
                           (torch.rand(16, 16, 3) * 255).to(torch.uint8).numpy())
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", CXX="no-such-cxx",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    for code in (f"from customnerf_torch.utils import jpeg; jpeg.read({path!r})",
                 "from customnerf_torch.utils import zstd; zstd.decompress(b'x')"):
        r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0
        assert "RuntimeError" in r.stderr and "no-such-cxx" in r.stderr, r.stderr


def test_cli_entry_point_needs_the_card():
    r = _run(["-m", "customnerf_torch", "-O", "--data_type", "synthetic"])
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr


def test_entry_points_raise_without_cpu_request(monkeypatch):
    from customnerf_torch import resolve_device
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.trainer import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = parse_args("-O --data_type synthetic --triplane_res 8 16 "
                     "--triplane_channels 4 2 --grid_type triplane".split())
    for make in (lambda: Trainer(opt), lambda: NeRFDataset(opt, "train"),
                 lambda: resolve_device("cuda")):
        with pytest.raises(RuntimeError, match="device='cpu'|not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")


def test_unported_options_name_their_roadmap_item(tmp_path):
    """``-O2``, ``--compact_frac -1``, the tiled / hash grid and ``--use_cd``
    are ported and construct, as are SD 2.x and ``--ckpt_format orbax``;
    a ``--mesh_shape`` larger than the world raises ``ValueError``."""
    from customnerf_torch.config import parse_args
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.guidance.sds import StableDiffusionGuidance
    from customnerf_torch.ops.grid import GridSpec
    grid = "--grid_type triplane --triplane_res 8 16 --triplane_channels 4 2"
    small = ("--grid_levels 4 --grid_base_resolution 4 --log2_hashmap_size 10 "
             "--desired_resolution 64")
    quiet = lambda *_: None                                     # noqa: E731
    for flags, dense, gridtype in (("-O2", True, "triplane"),
                                   ("-O --compact_frac -1", False, "triplane"),
                                   (f"-O --grid_type hash {small}", False, "hash"),
                                   (f"-O2 --grid_type tiled {small}", True, "tiled")):
        opt = parse_args(f"--data_type synthetic {grid} {flags}".split())
        tr = Trainer(opt, device="cpu", log=quiet)
        assert (tr.occ_state is None) == dense
        spec = tr.field.cfg.grid
        assert (spec.gridtype if isinstance(spec, GridSpec) else "triplane") == gridtype
    # --mesh_shape is ported: a mesh that needs more ranks than the world
    # (one process here) has raises, as the JAX make_mesh does
    opt = parse_args(f"--data_type synthetic {grid} -O --mesh_shape data:8".split())
    with pytest.raises(ValueError, match="needs 8 ranks, have 1"):
        Trainer(opt, device="cpu", log=quiet)
    # --ckpt_format orbax is ported: the asynchronous writer of .orbax directories
    from customnerf_torch.engine.checkpoint import AsyncSaver
    opt = parse_args(f"--data_type synthetic {grid} -O --ckpt_format orbax".split())
    assert isinstance(Trainer(opt, device="cpu", log=quiet).saver, AsyncSaver)
    # SD 2.x is ported: the JAX package's 2.x UNet and OpenCLIP ViT-H text
    # tower (shapes only, on the meta device)
    from customnerf_torch.guidance.sds import FULL_WIDTH_PARAMS
    opt = parse_args(f"-O --data_type nerfstudio {grid} --pretrained --sd_version 2.1 "
                     f"--allow_random_guidance".split())
    g2 = StableDiffusionGuidance(opt, device="meta")
    assert g2.unet.cfg.cross_attention_dim == 1024
    assert g2.unet.cfg.attention_head_dim == (5, 10, 20, 20)
    assert g2.text_encoder.model.text_model.cfg.hidden_act == "gelu"
    assert g2.param_counts()["text_encoder"] == FULL_WIDTH_PARAMS["2.x"]["text_encoder"]
    # --use_cd builds the guidance with the artifacts' adapters and token
    from customnerf_torch.guidance.custom_diffusion import extract_cd_kv, save_cd_artifacts
    stack = tiny_stack()
    cd_dir = str(tmp_path / "cd")
    save_cd_artifacts(cd_dir, extract_cd_kv(build_tiny_guidance(
        parse_args(["--data_type", "synthetic"]), stack).unet), {"<new1>": torch.ones(32)})
    opt = parse_args(f"-O --data_type nerfstudio {grid} --pretrained "
                     f"--allow_random_guidance --use_cd {cd_dir}".split())
    g = build_tiny_guidance(opt, stack)
    assert g.cd_kv is not None and len(g.cd_kv) == 10
    assert g.text_encoder.tokenize(["a <new1> bear"])[0][2] == 49408


TINY = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 2 "
        "--num_steps 8 --upsample_steps 0 --compact_frac 0.35 "
        "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
        "--data_type synthetic --h 16 --w 16 --train_size 6 --iters 12 "
        "--update_extra_interval 2 --occ_grid_size 16 --max_ray_batch 1000 "
        "--max_steps 32 --ckpt scratch").split()


def tiny_stack():
    """The tiny SD configs of the phase-2 drives (context width 32)."""
    from customnerf_torch.guidance.unet import UNetConfig
    from customnerf_torch.guidance.vae import VAEConfig
    return dict(unet_cfg=UNetConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                                    cross_attention_dim=32, attention_head_dim=4,
                                    norm_num_groups=8),
                vae_cfg=VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                                  norm_num_groups=8))


def build_tiny_guidance(opt, stack):
    """``StableDiffusionGuidance`` on the CPU at the tiny widths, weights
    from ``--seed`` as on the card."""
    from customnerf_torch.guidance.layers import build
    from customnerf_torch.guidance.sds import StableDiffusionGuidance
    from customnerf_torch.guidance.text import CLIPTextConfig, CLIPTextModel, TextEncoder
    gen = torch.Generator().manual_seed(opt.seed)
    text = TextEncoder(model=build(CLIPTextModel, CLIPTextConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4), generator=gen))
    return StableDiffusionGuidance(opt, device="cpu", text_encoder=text, **stack)


def test_tiny_training_run_on_cpu(tmp_path):
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.trainer import Trainer
    opt = parse_args(TINY + ["--workspace", str(tmp_path)])
    tr = Trainer(opt, device="cpu", log=lambda *_: None)
    train = NeRFDataset(opt, "train", device="cpu").dataloader()
    val = NeRFDataset(opt, "val", device="cpu").dataloader()
    tr.train(train, max_epochs=2)
    assert tr.global_step == 12 and tr.n_updates == 12
    assert tr.occ_state.iter_density == 6          # refreshed every 2 steps
    assert all(math.isfinite(v) for v in tr.stats["loss"])
    view = val.item(0)                             # 64×64: 4096 rays, 5 chunks
    out = tr.render_image(view.rays_o, view.rays_d)
    assert out["image"].shape == (4096, 3) and out["fg"]["depth"].shape == (4096,)
    assert bool(torch.isfinite(out["image"]).all())


def test_tiny_cli_nerfstudio_then_test_on_cpu(tmp_path, monkeypatch):
    """``python -m customnerf_torch`` on a tiny nerfstudio fixture (the
    CPU asked for): training with an evaluation each epoch, the test path,
    then ``--test`` from the best checkpoint; without cv2, the mp4 warning."""
    from customnerf_torch.__main__ import main
    from customnerf_torch.data import fixtures
    data = fixtures.write("nerfstudio", str(tmp_path / "data"), 8, 40, 30)
    flags = TINY[:TINY.index("--data_type")] + [
        "--train_size", "6", "--iters", "12", "--update_extra_interval", "2",
        "--occ_grid_size", "16", "--max_ray_batch", "1000", "--max_steps", "32",
        "--data_type", "nerfstudio", "--data_path", data, "--keyword", "lang_bear",
        "--train_resolution_level", "2", "--eval_resolution_level", "3",
        "--workspace", str(tmp_path / "ws")]
    monkeypatch.setitem(sys.modules, "cv2", None)
    lines = []
    tr = main(flags + ["--ckpt", "scratch"], log=lines.append, device="cpu")
    assert tr.global_step == 12 and len(tr.stats["results"]) == 2
    assert sorted(os.listdir(tmp_path / "ws" / "validation")) == [
        "df_ep0001.png", "df_ep0002.png"]
    assert "df.pth" in os.listdir(tmp_path / "ws" / "checkpoints")
    assert len(os.listdir(tmp_path / "ws" / "results" / "df_ep0002_test")) == 73
    best = str(tmp_path / "ws" / "checkpoints" / "df.pth")
    lines.clear()
    tt = main(flags + ["--test", "--ckpt", best], log=lines.append, device="cpu")
    assert tt.global_step == 6 * tt.epoch and f"[INFO] Loading {best} ..." in lines
    assert any(l.startswith("[WARN] mp4 write failed") for l in lines)


def test_tiny_phase1_checkpoint_phase2_on_cpu(tmp_path, monkeypatch):
    """scripts/bear.sh's two phases through the library entry points, the CPU
    asked for: reconstruct, save df_ep*.pth, load it with --pretrained
    --editing_from, and take LGIE/SDS editing steps with a tiny SD stack."""
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import editing
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.guidance.clip_view import (CLIPModel, CLIPViewMatcher,
                                                     CLIPVisionConfig)
    from customnerf_torch.guidance.layers import build
    from customnerf_torch.guidance.sds import StableDiffusionGuidance
    from customnerf_torch.guidance.text import CLIPTextConfig, CLIPTextModel, TextEncoder
    from customnerf_torch.guidance.unet import UNetConfig
    from customnerf_torch.guidance.vae import VAEConfig
    quiet = lambda *_: None
    p1 = parse_args(TINY + ["--workspace", str(tmp_path / "recon")])
    recon = Trainer(p1, device="cpu", log=quiet, use_checkpoint=p1.ckpt)
    recon.train(NeRFDataset(p1, "train", device="cpu").dataloader(), max_epochs=2)
    ckpt = tmp_path / "recon" / "checkpoints" / "df_ep0002.pth"
    assert ckpt.exists()

    phase2 = TINY + [
        "--workspace", str(tmp_path / "edit"), "--pretrained", "--editing_from",
        str(ckpt), "--text", "a corgi in a forest", "--text_fg", "a corgi",
        "--lambda_sd", "0.01", "--keep_bg", "1000", "--cfg", "100", "--random_bg_c",
        "--detach_bg", "--clip_view", "--stage_time", "--sd_version", "1.5"]
    with pytest.raises(RuntimeError, match="--allow_random_guidance"):
        StableDiffusionGuidance(parse_args(phase2), device="cpu")
    p2 = parse_args(phase2 + ["--allow_random_guidance"])
    text = TextEncoder(model=build(CLIPTextModel, CLIPTextConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4)))
    guidance = StableDiffusionGuidance(
        p2, device="cpu", text_encoder=text,
        unet_cfg=UNetConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                            cross_attention_dim=32, attention_head_dim=4,
                            norm_num_groups=8),
        vae_cfg=VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                          norm_num_groups=8))
    tiny_clip = build(CLIPModel, CLIPTextConfig(hidden_size=32, intermediate_size=64,
                                                num_hidden_layers=2, num_attention_heads=4),
                      CLIPVisionConfig(hidden_size=32, intermediate_size=64,
                                       num_hidden_layers=2, num_attention_heads=4),
                      projection_dim=16)
    edit = Trainer(p2, device="cpu", log=quiet, guidance=guidance, use_checkpoint=p2.ckpt)
    edit.clip_matcher = CLIPViewMatcher(model=tiny_clip)
    assert torch.equal(edit.occ_state.bitfield, recon.occ_state.bitfield)
    monkeypatch.setattr(editing, "RESIZE", 64)
    edit.train(NeRFDataset(p2, "train", device="cpu").dataloader(), max_epochs=2)
    assert edit.global_step == 12 and edit.n_updates == 12
    assert all(math.isfinite(v) for v in edit.stats["loss"])
    assert edit.pt_dict and all(e["match_probs"] is not None for e in edit.pt_dict.values())
    assert sorted(os.listdir(tmp_path / "edit" / "checkpoints")) == [
        "df_ep0000.pth", "df_ep0001.pth", "df_ep0002.pth"]


TINY_O2 = ("-O2 --grid_levels 4 --grid_level_dim 2 --grid_base_resolution 4 "
           "--log2_hashmap_size 10 --desired_resolution 64 --num_steps 8 "
           "--upsample_steps 8 --bound 2 --train_conf 0.01 --soft_mask "
           "--max_ray_batch 1000 --ckpt scratch").split()


def test_tiny_o2_cli_nerfstudio_then_test_on_cpu(tmp_path, monkeypatch):
    """``bear.sh --parity`` phase 1 in miniature through ``python -m
    customnerf_torch`` (the CPU asked for): ``-O2`` on a tiled grid, an
    evaluation each epoch with no occupancy grid in the checkpoints, the
    test path, then ``--test`` from the best checkpoint."""
    from customnerf_torch.__main__ import main
    from customnerf_torch.data import fixtures
    from customnerf_torch.engine import checkpoint
    data = fixtures.write("nerfstudio", str(tmp_path / "data"), 8, 40, 30)
    flags = TINY_O2 + [
        "--train_size", "6", "--iters", "12", "--data_type", "nerfstudio",
        "--data_path", data, "--keyword", "lang_bear", "--train_resolution_level", "2",
        "--eval_resolution_level", "3", "--workspace", str(tmp_path / "ws")]
    monkeypatch.setitem(sys.modules, "cv2", None)
    tr = main(flags, log=lambda *_: None, device="cpu")
    assert tr.global_step == 12 and tr.occ_state is None
    assert len(tr.stats["results"]) == 2
    assert all(math.isfinite(r) for r in tr.stats["results"])
    assert sorted(os.listdir(tmp_path / "ws" / "validation")) == [
        "df_ep0001.png", "df_ep0002.png"]
    best = str(tmp_path / "ws" / "checkpoints" / "df.pth")
    params, meta = checkpoint.load_checkpoint(best)
    assert "density_grid" not in meta and params["params"]["grid_table"].shape[1] == 2
    assert len(os.listdir(tmp_path / "ws" / "results" / "df_ep0002_test")) == 73
    lines = []
    tt = main(flags + ["--test", "--ckpt", best], log=lines.append, device="cpu")
    assert tt.epoch == tr.epoch and f"[INFO] Loading {best} ..." in lines
    assert torch.equal(tt.field.grid_table, tr.field.grid_table)


def test_tiny_o2_phase1_checkpoint_phase2_on_cpu(tmp_path, monkeypatch):
    """``bear.sh --parity``'s two phases on ``-O2``: reconstruct, save
    ``df_ep*.pth``, then ``--pretrained --editing_from`` it with a tiny SD
    stack; the frozen field renders as the saved one, the edit moves the
    field."""
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import editing
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.guidance.layers import build
    from customnerf_torch.guidance.sds import StableDiffusionGuidance
    from customnerf_torch.guidance.text import CLIPTextConfig, CLIPTextModel, TextEncoder
    from customnerf_torch.guidance.unet import UNetConfig
    from customnerf_torch.guidance.vae import VAEConfig
    quiet = lambda *_: None                                     # noqa: E731
    scene = ["--data_type", "synthetic", "--h", "16", "--w", "16", "--train_size", "6",
             "--iters", "12"]
    p1 = parse_args(TINY_O2 + scene + ["--workspace", str(tmp_path / "recon")])
    recon = Trainer(p1, device="cpu", log=quiet, use_checkpoint=p1.ckpt)
    recon.train(NeRFDataset(p1, "train", device="cpu").dataloader(), max_epochs=2)
    ckpt = tmp_path / "recon" / "checkpoints" / "df_ep0002.pth"
    assert ckpt.exists()

    p2 = parse_args(TINY_O2 + scene + [
        "--workspace", str(tmp_path / "edit"), "--pretrained", "--editing_from",
        str(ckpt), "--text", "a corgi in a forest", "--text_fg", "a corgi",
        "--lambda_sd", "0.01", "--keep_bg", "1000", "--cfg", "100", "--random_bg_c",
        "--detach_bg", "--stage_time", "--sd_version", "1.5",
        "--allow_random_guidance"])
    text = TextEncoder(model=build(CLIPTextModel, CLIPTextConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4)))
    guidance = StableDiffusionGuidance(
        p2, device="cpu", text_encoder=text,
        unet_cfg=UNetConfig(block_out_channels=(32, 64, 64, 64), layers_per_block=1,
                            cross_attention_dim=32, attention_head_dim=4,
                            norm_num_groups=8),
        vae_cfg=VAEConfig(block_out_channels=(16, 16, 32, 32), layers_per_block=1,
                          norm_num_groups=8))
    edit = Trainer(p2, device="cpu", log=quiet, guidance=guidance, use_checkpoint=p2.ckpt)
    assert edit.occ_state is None
    view = NeRFDataset(p2, "val", device="cpu").dataloader().item(0)
    a = recon.render_image(view.rays_o, view.rays_d)
    b = edit.render_image(view.rays_o, view.rays_d, field=edit.field_pretrained)
    assert torch.equal(a["image"], b["image"])
    before = edit.field.grid_table.detach().clone()
    monkeypatch.setattr(editing, "RESIZE", 64)
    edit.train(NeRFDataset(p2, "train", device="cpu").dataloader(), max_epochs=2)
    assert edit.global_step == 12 and edit.n_updates == 12
    assert all(math.isfinite(v) for v in edit.stats["loss"]) and edit.pt_dict
    assert not torch.equal(edit.field.grid_table, before)


C1_WARNINGS = {"triplane_bwd": (["--triplane_bwd", "scatter"], "same numbers"),
               "compact_layout": (["--compact_layout", "wide"], "same numbers")}


@pytest.mark.parametrize("flag", sorted(C1_WARNINGS) + [
    "profile", "validate_weights", "triplane_fwd_bf16", "steps_per_dispatch"])
def test_c1_flags_warn_trace_or_run_the_drill(tmp_path, capsys, monkeypatch, flag):
    """The flags the JAX package acts on: each warns (saying the JAX paths
    compute the same numbers), traces the first epoch (``--profile``), runs
    the drill and exits without training (``--validate_weights``) or,
    ported since, acts without a warning (``--triplane_fwd_bf16``: the
    field's encoder gathers bf16 rows; ``--steps_per_dispatch``: K steps a
    dispatch, ≤ 0 resolved as the JAX package resolves it)."""
    import json
    from customnerf_torch.config import parse_args
    if flag == "triplane_fwd_bf16":
        from customnerf_torch.engine.trainer import build_field
        opt = parse_args(TINY + ["--triplane_fwd_bf16"])
        assert "[WARN]" not in capsys.readouterr().out
        field, plain = build_field(opt, device="cpu"), build_field(parse_args(TINY), "cpu")
        assert field.cfg.grid.fwd_bf16 and not plain.cfg.grid.fwd_bf16
        x = torch.rand(64, 3, generator=torch.Generator().manual_seed(0)) * 2 - 1
        with torch.no_grad():
            a, b = field._encode(x)[1], plain._encode(x)[1]
            table = plain.grid_table.to(torch.bfloat16).float()
            plain.grid_table.copy_(table)
            c = plain._encode(x)[1]
        # the same field on bf16-rounded rows: the table's values, rounded
        assert not torch.equal(a, b) and torch.allclose(a, c, rtol=0, atol=1e-7)
    elif flag == "steps_per_dispatch":
        from customnerf_torch.engine.trainer import Trainer
        opt = parse_args(TINY + ["--steps_per_dispatch", "8"])
        assert "[WARN]" not in capsys.readouterr().out
        # resolved as the JAX package does: <= 0 is 8 on the card, 1 on the CPU
        assert Trainer(opt, device="cpu", log=lambda *_: None).steps_per_dispatch() == 8
        for k in (0, -1):
            opt = parse_args(TINY + ["--steps_per_dispatch", str(k)])
            assert Trainer(opt, device="cpu", log=lambda *_: None).steps_per_dispatch() == 1
    elif flag in C1_WARNINGS:
        extra, why = C1_WARNINGS[flag]
        parse_args(TINY + extra)
        out = capsys.readouterr().out
        assert f"[WARN] --{flag}=" in out and why in out, out
        parse_args(TINY)
        assert "[WARN]" not in capsys.readouterr().out
    elif flag == "profile":
        from customnerf_torch.data.base import NeRFDataset
        from customnerf_torch.engine.trainer import Trainer
        opt = parse_args(TINY + ["--profile", "--workspace", str(tmp_path)])
        lines = []
        tr = Trainer(opt, device="cpu", log=lines.append)
        tr.train(NeRFDataset(opt, "train", device="cpu").dataloader(), max_epochs=2)
        assert os.listdir(tmp_path / "profile") == ["trace_ep0001.json"]
        with open(tmp_path / "profile" / "trace_ep0001.json") as f:
            events = json.load(f)["traceEvents"]
        assert any("aten::" in e.get("name", "") for e in events)
        assert not opt.profile and sum("--profile" in l for l in lines) == 1
    else:
        from customnerf_torch import __main__ as cli
        from customnerf_torch.guidance import validate

        def no_trainer(*a, **k):
            raise AssertionError("--validate_weights built a trainer")

        monkeypatch.setattr(validate, "StableDiffusionGuidance",
                            lambda opt, device=None: build_tiny_guidance(opt, tiny_stack()))
        monkeypatch.setattr(cli, "Trainer", no_trainer)
        with pytest.raises(SystemExit) as e:
            cli.main(["--validate_weights", "--data_type", "synthetic"], device="cpu")
        assert e.value.code == 0
        report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert report["ok"] and report["eps_prediction"]["finite"]


def test_tiny_tune_then_use_cd_editing_on_cpu(tmp_path, monkeypatch):
    """The image-driven edit from end to end, the CPU asked for: JPEG concept
    images → ``python -m customnerf_torch.tune_custom_diffusion`` (2 steps,
    a checkpoint) → phase 1 → ``--pretrained --editing_from … --use_cd
    <its output>`` editing with ``<new1>`` in the prompts."""
    import numpy as np
    from customnerf_torch import tune_custom_diffusion
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine import editing
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.utils.jpeg import write_jpeg
    quiet = lambda *_: None                                     # noqa: E731
    inst = tmp_path / "inst"
    inst.mkdir()
    rs = np.random.RandomState(0)
    for i in range(3):                          # 48×40: enlarged to 64
        write_jpeg(str(inst / f"v{i}.jpg"), (rs.rand(48, 40, 3) * 255).astype(np.uint8))
    stack = tiny_stack()
    out = tune_custom_diffusion.main(
        ["--instance_data_dir", str(inst), "--instance_prompt", "bear", "--output_dir",
         str(tmp_path / "cd"), "--resolution", "64", "--max_train_steps", "2",
         "--train_batch_size", "1", "--checkpointing_steps", "1"],
        device="cpu", log=quiet,
        guidance=build_tiny_guidance(parse_args(["--data_type", "synthetic", "--seed", "42"]),
                                     stack))
    assert sorted(os.listdir(out)) == ["<new1>.bin", "checkpoint-1",
                                       "pytorch_custom_diffusion_weights.bin"]

    p1 = parse_args(TINY + ["--iters", "6", "--workspace", str(tmp_path / "recon")])
    recon = Trainer(p1, device="cpu", log=quiet, use_checkpoint=p1.ckpt)
    recon.train(NeRFDataset(p1, "train", device="cpu").dataloader(), max_epochs=1)
    ckpt = tmp_path / "recon" / "checkpoints" / "df_ep0001.pth"
    p2 = parse_args(TINY + [
        "--iters", "6", "--workspace", str(tmp_path / "edit"), "--pretrained",
        "--editing_from", str(ckpt), "--text", "a <new1> bear in a forest",
        "--text_fg", "a <new1> bear", "--lambda_sd", "0.01", "--keep_bg", "1000",
        "--cfg", "100", "--random_bg_c", "--detach_bg", "--stage_time", "--sd_version",
        "1.5", "--allow_random_guidance", "--use_cd", out])
    guidance = build_tiny_guidance(p2, stack)
    assert guidance.cd_kv is not None
    assert guidance.text_encoder.tokenize(["a <new1> bear"])[0][2] == 49408
    x, ctx = torch.randn(2, 4, 8, 8), guidance.get_text_embeds(["a <new1> bear"], [""])
    with torch.no_grad():
        with_cd = guidance.unet(x, torch.tensor([500, 500]), ctx, cd_kv=guidance.cd_kv)
        without = guidance.unet(x, torch.tensor([500, 500]), ctx)
    assert not torch.equal(with_cd, without)
    edit = Trainer(p2, device="cpu", log=quiet, guidance=guidance, use_checkpoint=p2.ckpt)
    monkeypatch.setattr(editing, "RESIZE", 64)
    edit.train(NeRFDataset(p2, "train", device="cpu").dataloader(), max_epochs=1)
    assert edit.global_step == 6 and all(math.isfinite(v) for v in edit.stats["loss"])
