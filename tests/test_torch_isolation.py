"""The port stands alone: ``customnerf_torch``, ``chip_smoke.py`` and the
study tools in ``tools/`` import nothing of JAX, nothing of the JAX package,
and none of ``transformers``, ``safetensors`` or ``cv2`` (the card's machine
may lack them), and the entry points run on the card unless the caller asks
for the CPU.  Plus tiny end-to-end runs on the CPU (control flow, not
speed): the trainer loop, the CLI on a nerfstudio fixture then ``--test``,
and phase 1 → checkpoint → phase 2 (editing)."""

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
             "cv2"):
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
              "safetensors", "cv2") and sys.modules[m] is not None)
assert {"customnerf_torch.utils.png", "customnerf_torch.utils.resample",
        "customnerf_torch.data.nerfstudio", "customnerf_torch.data.llff",
        "customnerf_torch.data.dtu", "customnerf_torch.data.fixtures"} <= set(mods)
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


def test_unported_options_name_their_roadmap_item():
    from customnerf_torch.config import parse_args
    from customnerf_torch.engine.trainer import Trainer
    from customnerf_torch.guidance.sds import StableDiffusionGuidance
    grid = "--grid_type triplane --triplane_res 8 16 --triplane_channels 4 2"
    for flags in ("-O2", "-O --compact_frac -1", "-O --grid_type hash"):
        opt = parse_args(f"--data_type synthetic {grid} {flags}".split())
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(opt, device="cpu", log=lambda *_: None)
    for flags in ("--use_cd x", "--sd_version 2.1"):
        opt = parse_args(f"-O --data_type nerfstudio {grid} --pretrained {flags}".split())
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            StableDiffusionGuidance(opt, device="cpu")


TINY = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 2 "
        "--num_steps 8 --upsample_steps 0 --compact_frac 0.35 "
        "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
        "--data_type synthetic --h 16 --w 16 --train_size 6 --iters 12 "
        "--update_extra_interval 2 --occ_grid_size 16 --max_ray_batch 1000 "
        "--max_steps 32 --ckpt scratch").split()


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
