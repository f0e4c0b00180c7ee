"""The port's data loaders against the JAX package's on the same fixtures,
made by the repo's own scripts (``scripts/make_bear_fixture.py``,
``scripts/make_llff_dtu_fixtures.py``) at 8 views of 40×30 with the real
cv2: nerfstudio (pinhole, OPENCV_FISHEYE, an ``R_path`` pose correction,
``--dont_inter_test``, ``--val_all_images``), LLFF (NDC, ``--is360Scene``,
``--inter_pose``) and DTU, each for the train, val and test splits.

Tolerances: images and masks ≤ 1e-5 (the same float64 resampling, cast to
f32); rays ≤ 1e-6 (the same f32 numpy math; the JAX pinhole path runs it
in C++), NDC rays ≤ 1e-5 (divisions by small z); counts, sizes and paths
equal.  ``load_K_Rt_from_P`` (RQ in place of cv2) ≤ 1e-9.  The port's
cv2-free fixture writer gives the same pixels and metadata as the scripts.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest

from customnerf_torch.data import fixtures

cv2 = pytest.importorskip("cv2")

from customnerf_tpu import config as jconfig  # noqa: E402
from customnerf_tpu.data import base as jbase  # noqa: E402
from customnerf_tpu.data import dtu as jdtu  # noqa: E402
from customnerf_torch import config as tconfig  # noqa: E402
from customnerf_torch.data import base as tbase  # noqa: E402
from customnerf_torch.data import dtu as tdtu  # noqa: E402

VIEWS, W, H = 8, 40, 30


def _with_real_cv2(writer, out):
    """The scripts' own writers, cv2 and all."""
    if writer == "bear":
        argv = sys.argv
        sys.argv = ["make_bear_fixture.py", out, str(VIEWS), str(W), str(H)]
        try:
            fixtures._script("make_bear_fixture").main()
        finally:
            sys.argv = argv
    else:
        fixtures._script("make_bear_fixture")
        getattr(fixtures._script("make_llff_dtu_fixtures"), f"make_{writer}")(
            out, VIEWS, W, H)
    return out


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("scenes")
    out = {t: _with_real_cv2(t, str(root / t)) for t in ("bear", "llff", "dtu")}
    fish = str(root / "fisheye")
    shutil.copytree(out["bear"], fish)
    meta_path = os.path.join(fish, "transforms.json")
    with open(meta_path) as f:
        meta = json.load(f)
    meta.update(camera_model="OPENCV_FISHEYE", k1=0.05, k2=-0.01, k3=0.002,
                k4=0.0, p1=0.001, p2=-0.002)
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    out["fisheye"] = fish
    # a small rotation and shift of every training view (the R_path file)
    rng = np.random.RandomState(0)
    from scipy.spatial.transform import Rotation
    n_train = int(np.ceil(VIEWS * 0.9))
    R = np.tile(np.eye(4, dtype=np.float32), (n_train, 1, 1))
    R[:, :3, :3] = Rotation.from_rotvec(rng.randn(n_train, 3) * 0.02).as_matrix()
    R[:, :3, 3] = rng.randn(n_train, 3) * 0.01
    out["R_path"] = str(root / "R.npy")
    np.save(out["R_path"], R)
    return out


CASES = {
    "nerfstudio": ("bear", "--data_type nerfstudio --keyword lang_bear", False),
    "nerfstudio_fisheye": ("fisheye", "--data_type nerfstudio --keyword lang_bear", False),
    "nerfstudio_R_path": ("bear", "--data_type nerfstudio --keyword lang_bear", True),
    "nerfstudio_dont_inter_test_val_all": (
        "bear", "--data_type nerfstudio --keyword lang_bear --dont_inter_test "
        "--val_all_images", False),
    "llff_ndc": ("llff", "--data_type llff --keyword lang_bear", False),
    "llff_360": ("llff", "--data_type llff --keyword lang_bear --is360Scene", False),
    "llff_inter_pose": ("llff", "--data_type llff --inter_pose", False),
    "dtu": ("dtu", "--data_type dtu --if_sphere", False),
}


def _flags(scenes, case):
    scene, flags, _ = CASES[case]
    return (f"-O {flags} --data_path {scenes[scene]} --train_resolution_level 2 "
            f"--eval_resolution_level 3 --train_size 7").split()


@pytest.mark.parametrize("split", ["train", "val", "test"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_provider_matches_jax(scenes, case, split):
    flags = _flags(scenes, case)
    R_path = scenes["R_path"] if CASES[case][2] and split == "train" else None
    j = jbase.NeRFDataset(jconfig.parse_args(flags), split, R_path=R_path).dataloader()
    t = tbase.NeRFDataset(tconfig.parse_args(flags), split, R_path=R_path,
                          device="cpu").dataloader()
    assert type(t).__name__ == type(j).__name__
    assert (len(t), t.n_images, t.H, t.W, t.images_lis) == \
        (len(j), j.n_images, j.H, j.W, j.images_lis)
    ray_tol = 1e-5 if case == "llff_ndc" or case == "llff_inter_pose" else 1e-6
    for name, tol in (("images_flat", 1e-5), ("masks_flat", 1e-5),
                      ("origins_flat", ray_tol), ("directions_flat", ray_tol)):
        want = np.asarray(getattr(j, name))
        got = getattr(t, name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)
    if split != "train":       # the train split draws its image at random
        for i in (0, len(t) - 1):
            bj, bt = j.item(i), t.item(i)
            assert (bt.H, bt.W, bt.img_path, bt.index) == (bj.H, bj.W, bj.img_path, bj.index)
            np.testing.assert_allclose(bt.rgbs.numpy(), np.asarray(bj.rgbs), atol=1e-5)
            np.testing.assert_allclose(bt.rays_d.numpy(), np.asarray(bj.rays_d),
                                       atol=ray_tol)


def test_split_sizes_of_the_bear_fixture(scenes):
    """8 views: 8 train views (⌈0.9·8⌉), 4 val views, 73 slerp test poses
    (3 gaps of 25, shared ends) whose target is a placeholder."""
    flags = _flags(scenes, "nerfstudio")
    opt = tconfig.parse_args(flags)
    sizes = {s: tbase.NeRFDataset(opt, s, device="cpu").dataloader() for s in
             ("train", "val", "test")}
    assert sizes["train"].n_images == 8 and len(sizes["train"]) == 7
    assert len(sizes["val"]) == 4 and len(sizes["test"]) == 73
    assert sizes["test"].images_flat.shape[0] == 1


def test_load_K_Rt_from_P_matches_cv2_decomposition():
    rng = np.random.RandomState(0)
    for k in range(200):
        P = rng.randn(3, 4) * rng.choice([1e-2, 1.0, 1e2])
        if k % 4 == 0:   # a realistic camera: K @ [R | t]
            from scipy.spatial.transform import Rotation
            K = np.array([[350.0, 0.3, 200.0], [0, 340.0, 150.0], [0, 0, 1]])
            Rm = Rotation.from_rotvec(rng.randn(3)).as_matrix()
            P = K @ np.concatenate([Rm, rng.randn(3, 1)], axis=1)
        ki, pi = jdtu.load_K_Rt_from_P(P)
        kt, pt = tdtu.load_K_Rt_from_P(P)
        assert kt.dtype == ki.dtype and pt.dtype == pi.dtype
        np.testing.assert_allclose(kt, ki, rtol=0, atol=1e-9 * max(1.0, np.abs(ki).max()))
        np.testing.assert_allclose(pt, pi, rtol=0, atol=1e-9 * max(1.0, np.abs(pi).max()))


@pytest.mark.parametrize("data_type", ["nerfstudio", "llff", "dtu"])
def test_stand_in_writer_equals_the_scripts(scenes, tmp_path, data_type):
    """``data/fixtures.py`` (cv2 replaced by ``utils/png.py``) against the
    scripts with the real cv2: the same decoded pixels, the same json / npy
    / npz contents; and cv2 is the real module again afterwards."""
    real = sys.modules["cv2"]
    out = fixtures.write(data_type, str(tmp_path), VIEWS, W, H)
    assert sys.modules["cv2"] is real
    ref = scenes[fixtures.WRITERS[data_type][0]]
    names = sorted(os.path.relpath(os.path.join(d, f), ref)
                   for d, _, fs in os.walk(ref) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(d, f), out)
                           for d, _, fs in os.walk(out) for f in fs)
    for name in names:
        a, b = os.path.join(out, name), os.path.join(ref, name)
        if name.endswith(".png"):
            np.testing.assert_array_equal(cv2.imread(a, cv2.IMREAD_UNCHANGED),
                                          cv2.imread(b, cv2.IMREAD_UNCHANGED))
        elif name.endswith(".npz"):
            x, y = np.load(a), np.load(b)
            assert sorted(x.files) == sorted(y.files)
            for k in y.files:
                np.testing.assert_array_equal(x[k], y[k])
        elif name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(a), np.load(b))
        else:
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb)


def test_stand_in_is_removed_when_cv2_is_absent(tmp_path, monkeypatch):
    monkeypatch.delitem(sys.modules, "cv2")
    fixtures.write("dtu", str(tmp_path), 2, 8, 6)
    assert "cv2" not in sys.modules
