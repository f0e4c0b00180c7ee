"""The port stands alone: ``customnerf_torch``, ``chip_smoke.py`` and the
study tools in ``tools/`` import nothing of JAX and nothing of the JAX
package, and the entry points run on the card unless the caller asks for the
CPU.  Plus a tiny end-to-end run of the trainer loop on the CPU (control
flow, not speed)."""

import math
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax"):
    sys.modules[name] = None          # any import of them now fails
import customnerf_torch
mods = [m.name for m in pkgutil.walk_packages(customnerf_torch.__path__,
                                              "customnerf_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
import tools.device_probe, tools.kernel_study
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("customnerf_tpu", "jax", "jaxlib", "flax", "optax")
             and sys.modules[m] is not None)
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
    assert int(r.stdout.split()[-1]) >= 20


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
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.trainer import Trainer
    grid = "--grid_type triplane --triplane_res 8 16 --triplane_channels 4 2"
    for flags in ("-O2", "-O --compact_frac -1", "-O --grid_type hash"):
        opt = parse_args(f"--data_type synthetic {grid} {flags}".split())
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Trainer(opt, device="cpu", log=lambda *_: None)
    opt = parse_args(f"-O --data_type llff --data_path x {grid}".split())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        NeRFDataset(opt, "train", device="cpu")


def test_tiny_training_run_on_cpu():
    from customnerf_torch.config import parse_args
    from customnerf_torch.data.base import NeRFDataset
    from customnerf_torch.engine.trainer import Trainer
    opt = parse_args(
        ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 2 "
         "--num_steps 8 --upsample_steps 0 --compact_frac 0.35 "
         "--compact_block 8 --bound 2 --train_conf 0.01 --soft_mask "
         "--data_type synthetic --h 16 --w 16 --train_size 6 --iters 12 "
         "--update_extra_interval 2 --occ_grid_size 16 --max_ray_batch 1000 "
         "--max_steps 32").split())
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
