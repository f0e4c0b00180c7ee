"""Evaluation, test renders and CLIP metrics of the port's trainer against
the JAX package's, on the CPU.

* ``evaluate_one_epoch`` on a tiny tri-plane field (parameters carried
  across from flax, one occupancy grid, the val split of a tiny bear
  fixture, ``perturb`` off, f32 heads on both sides): the frames' renders
  ≤ 1e-4, the strip PNG's pixels within one level of 255 (a render that
  differs by an ulp can round to the other byte), the per-view PSNRs
  ≤ 1e-3 dB, and the best checkpoint ``df.pth``, which reloads with its
  occupancy grid.
* ``test``: one PNG a pose, and the JAX package's mp4 warning when ``cv2``
  cannot be imported.
* ``report_clip_metrics`` against the JAX function with the tiny CLIP of
  ``tests/test_torch_text_clip.py``: scores ≤ 1e-5, the same warnings.
"""

import dataclasses
import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from customnerf_tpu import config as jconfig
from customnerf_tpu.data import base as jbase
from customnerf_tpu.engine import trainer as jtrainer
from customnerf_tpu.models import field as jfield
from customnerf_tpu.ops import occupancy as jocc
from customnerf_torch import config as tconfig
from customnerf_torch.data import base as tbase
from customnerf_torch.data import fixtures
from customnerf_torch.engine import convert
from customnerf_torch.engine.trainer import Trainer, build_field, field_config
from customnerf_torch.models.field import NeRFField
from customnerf_torch.ops import occupancy as tocc
from customnerf_torch.utils import png

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_guidance import one_thread  # noqa: E402,F401

cv2 = pytest.importorskip("cv2")

G = 16
FLAGS = ("-O --grid_type triplane --triplane_res 8 16 --triplane_channels 4 4 "
         "--num_steps 16 --upsample_steps 0 --compact_frac 0.5 --compact_block 8 "
         "--bound 2 --train_conf 0.01 --soft_mask --occ_grid_size 16 "
         "--max_steps 64 --max_ray_batch 100 --data_type nerfstudio "
         "--keyword lang_bear --eval_resolution_level 3 --iters 100").split()


def f32_field(opt):
    """``build_field(opt)`` in the JAX side's f32 setting: f32 heads
    (``compute_dtype="float32"``; ``-O`` picks bf16 ones) and an f32
    tri-plane table gradient (``mm_bf16=False``)."""
    cfg = field_config(opt)
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              grid=dataclasses.replace(cfg.grid, mm_bf16=False))
    return NeRFField(cfg, seed=opt.seed, device="cpu")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return fixtures.write("nerfstudio", str(tmp_path_factory.mktemp("bear")), 8, 40, 30)


def _pair(scene, workspace):
    """A JAX trainer with an f32 field and the port's trainer, with the
    same parameters and occupancy grid."""
    flags = FLAGS + ["--data_path", scene, "--workspace", str(workspace)]
    jopt, topt = jconfig.parse_args(flags), tconfig.parse_args(flags)
    spec = dataclasses.replace(jtrainer.build_encoder_spec(jopt), mm_bf16=False)
    jf = jfield.NeRFField(jfield.FieldConfig(bound=2.0, grid=spec))
    jt = jtrainer.Trainer("df", jopt, field=jf, workspace=str(workspace / "jax"))
    field = f32_field(topt)
    params = convert.params_to_flax(field.state_dict())
    rng = np.random.RandomState(0)
    params["params"]["grid_table"] = (rng.randn(
        *params["params"]["grid_table"].shape) * 0.5).astype(np.float32)
    field.load_state_dict(convert.params_from_flax(params))
    jt.params = jax.tree_util.tree_map(jnp.asarray, params)
    dens = (rng.rand(2, G ** 3) < 0.6).astype(np.float32) * 50.0
    jt.occ_state = jocc.state_from_grid(dens, 1.0, density_thresh=10.0, grid_size=G)
    logs = []
    tt = Trainer(topt, field=field, device="cpu", log=logs.append)
    tt.occ_state = tocc.state_from_grid(torch.tensor(dens), 1.0, 10.0, grid_size=G)
    jt.epoch = tt.epoch = 3
    return jt, tt, jopt, topt, logs


def test_evaluation_strip_psnr_and_best_checkpoint_match_jax(scene, tmp_path, monkeypatch):
    jt, tt, jopt, topt, logs = _pair(scene, tmp_path)
    frames = []
    fetch = jtrainer.fetch_tree

    def recording(tree):
        out = fetch(tree)
        frames.append(np.asarray(out["image"]))
        return out

    monkeypatch.setattr(jtrainer, "fetch_tree", recording)
    jt.evaluate_one_epoch(jbase.NeRFDataset(jopt, "val").dataloader())

    val = tbase.NeRFDataset(topt, "val", device="cpu").dataloader()
    renders = [tt.render_image(b.rays_o, b.rays_d)["image"].numpy() for b in val]
    psnrs = tt.evaluate_one_epoch(val)
    assert len(frames) == len(renders) == len(psnrs) == 4
    want = []
    for f, r, b in zip(frames, renders, val):
        np.testing.assert_allclose(r, f, rtol=0, atol=1e-4)
        gt = b.rgbs.numpy()
        want.append(-10.0 * np.log10(max(float(np.mean((f - gt) ** 2)), 1e-10)))
    np.testing.assert_allclose(psnrs, want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tt.stats["results"], jt.stats["results"], atol=1e-3)

    got = png.read(str(tmp_path / "validation" / "df_ep0003.png"))
    ref = cv2.imread(str(tmp_path / "jax" / "validation" / "df_ep0003.png"))[..., ::-1]
    assert got.shape == ref.shape == (4 * 10, 7 * 13, 3)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    assert any(line.startswith("++> eval PSNR") for line in logs)

    # the best checkpoint: written with the grid, reloads to the same field
    path = tmp_path / "checkpoints" / "df.pth"
    assert path.exists() and (tmp_path / "jax" / "checkpoints" / "df.pth").exists()
    again = Trainer(topt, device="cpu", log=lambda *_: None, use_checkpoint=str(path))
    for (n, p), q in zip(tt.field.state_dict().items(), again.field.state_dict().values()):
        assert torch.equal(p, q), n
    assert torch.equal(again.occ_state.bitfield, tt.occ_state.bitfield)
    assert again.epoch == 3 and again.stats["best_result"] == tt.stats["best_result"]
    # a worse evaluation keeps the best file (every colour pushed toward
    # white; the first assertion checks that this evaluation is worse)
    before = path.stat().st_mtime_ns
    with torch.no_grad():
        tt.field.rgb_net.out.weight.zero_()
        tt.field.rgb_net.out.weight[:3, :] = 1.0
    tt.evaluate_one_epoch(val)
    assert tt.stats["results"][-1] > tt.stats["best_result"]
    assert path.stat().st_mtime_ns == before


def test_val_all_images_writes_one_strip_a_view(scene, tmp_path):
    _, tt, _, topt, _ = _pair(scene, tmp_path)
    tt.opt.val_all_images = True
    val = tbase.NeRFDataset(tt.opt, "val", device="cpu").dataloader()
    assert len(tt.evaluate_one_epoch(val)) == len(val) == 8
    assert sorted(os.listdir(tmp_path / "validation_all")) == sorted(
        f"{i}.png" for i in range(1, 9))


def test_test_renders_one_frame_a_pose_and_warns_without_cv2(scene, tmp_path, monkeypatch):
    _, tt, _, topt, logs = _pair(scene, tmp_path)
    tt.opt.render_all = True
    loader = tbase.NeRFDataset(topt, "test", device="cpu").dataloader()
    monkeypatch.setitem(sys.modules, "cv2", None)      # `import cv2` fails
    paths = tt.test(loader, split="test")
    out_dir = tmp_path / "results" / "df_ep0003_test"
    assert len(paths) == len(os.listdir(out_dir)) == 73
    assert png.read(paths[0]).shape == (10, 4 * 13, 3)   # rgb | mask | fg | bg
    warn = [l for l in logs if l.startswith("[WARN] mp4 write failed (")]
    assert warn and warn[0].endswith("); PNGs saved.")
    assert not (tmp_path / "results" / "df_ep0003_test_rgb.mp4").exists()


def _namespace(opt, matcher=None):
    logs = []
    ns = types.SimpleNamespace(opt=opt, log=logs.append, writer=None,
                               global_step=0)
    if matcher is not None:
        ns.clip_matcher = matcher
    return ns, logs


def test_report_clip_metrics_matches_jax(tmp_path):
    from test_torch_text_clip import make_clip_pair
    jm, tm = make_clip_pair()
    rng = np.random.RandomState(0)
    after = rng.rand(3, 40, 48, 3).astype(np.float32)
    before = rng.rand(3, 40, 48, 3).astype(np.float32)
    flags = ["--text", "a corgi", "--clip_ref_text", "a bear", "--clip_metrics"]
    jns, jlogs = _namespace(jconfig.parse_args(flags), jm)
    tns, tlogs = _namespace(tconfig.parse_args(flags), tm)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = jtrainer.Trainer.report_clip_metrics(jns, after, before, str(tmp_path / "j"), "x")
    got = Trainer.report_clip_metrics(tns, after, before, str(tmp_path / "t"), "x")
    assert set(got) == set(want) == {"clip_score", "text", "n_views",
                                     "clip_directional", "ref_text"}
    for k in ("clip_score", "clip_directional"):
        assert got[k] == pytest.approx(want[k], abs=1e-5)
    with open(tmp_path / "t" / "x_clip_metrics.json") as f:
        assert json.load(f)["n_views"] == 3

    # no --clip_ref_text: the same warning, no directional score
    jns, jlogs = _namespace(jconfig.parse_args(flags[:2] + ["--clip_metrics"]), jm)
    tns, tlogs = _namespace(tconfig.parse_args(flags[:2] + ["--clip_metrics"]), tm)
    want = jtrainer.Trainer.report_clip_metrics(jns, after, before, str(tmp_path / "j"), "y")
    got = Trainer.report_clip_metrics(tns, after, before, str(tmp_path / "t"), "y")
    assert "clip_directional" not in got and got["clip_score"] == pytest.approx(
        want["clip_score"], abs=1e-5)
    assert [l for l in tlogs if l.startswith("[WARN]")] == \
        [l for l in jlogs if l.startswith("[WARN]")] != []

    # no matcher, no --clip_weights, no --allow_random_guidance: skipped
    jns, jlogs = _namespace(jconfig.parse_args(flags))
    tns, tlogs = _namespace(tconfig.parse_args(flags))
    assert jtrainer.Trainer.report_clip_metrics(jns, after, None, str(tmp_path), "z") is None
    assert Trainer.report_clip_metrics(tns, after, None, str(tmp_path), "z") is None
    assert tlogs == jlogs and "RANDOM CLIP" in tlogs[0]
