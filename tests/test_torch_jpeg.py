"""The port's JPEG codec (``customnerf_torch/utils/jpeg.py``) against
libjpeg: ``cv2.imread(…, IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION)`` and,
where its codec build loads, the JAX package's native decoder
(``csrc/dataio.cpp``, libjpeg with its defaults), on files written by
``cv2.imwrite`` and PIL at qualities 50-100 with 4:4:4, 4:2:2, 4:2:0,
4:4:0 and 4:1:1 sampling, odd sizes, grayscale and restart intervals.
Tolerance: 1 level, with the count of unequal pixels reported (the islow
IDCT, fancy upsampling and the fixed-point colour tables are libjpeg's, so
every case here is expected to be exact).  The encoder's files decode in
cv2 to the source within the PSNR cv2's own encoder reaches, and the
loaders read the reference layout (``.jpg`` images, ``.png`` masks) equal
to the JAX providers."""

import io
import json
import os

import numpy as np
import pytest

from customnerf_torch.utils import jpeg, png, resample

cv2 = pytest.importorskip("cv2")
Image = pytest.importorskip("PIL.Image")

SAMPLING = {"444": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444, 0),
            "422": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422, 1),
            "420": (cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420, 2)}


def _scene(h, w, seed=0, noise=20.0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 3 + yy) % 256, (yy * 5) % 256, ((xx - yy) * 2) % 256], -1)
    return np.clip(img + rs.randn(h, w, 3) * noise, 0, 255).astype(np.uint8)


def _libjpeg(path):
    return cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)[..., ::-1]


def _native(path, h, w):
    from customnerf_tpu.utils import native
    if not native.has_image_codecs():
        return None
    out = native.decode_resize_batch([path], h, w, scale=1.0)
    return None if out is None else out[0]


def _check(path, ref):
    got = jpeg.read(path)
    assert got.shape == ref.shape and got.dtype == np.uint8
    err = np.abs(got.astype(np.int64) - ref).max()
    unequal = int((got != ref).any(-1).sum())
    assert err <= 1, f"{path}: max error {err}, {unequal} unequal pixels"
    return got, unequal


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("writer", ["cv2", "pil"])
def test_decode_equals_libjpeg(tmp_path, writer, quality, sampling):
    img = _scene(61, 83, seed=quality)                   # odd: partial MCUs
    path = str(tmp_path / "x.jpg")
    if writer == "cv2":
        cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality,
                                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                           SAMPLING[sampling][0]])
    else:
        Image.fromarray(img).save(path, quality=quality, subsampling=SAMPLING[sampling][1])
    got, unequal = _check(path, _libjpeg(path))
    assert unequal == 0
    native = _native(path, 61, 83)
    if native is not None:
        np.testing.assert_array_equal(got.astype(np.float32), native)
    assert jpeg.dims(path) == png.dims(path) == (61, 83)


@pytest.mark.parametrize("case", ["gray", "restart", "h1v2", "h4v1", "odd_tiny"])
def test_decode_other_layouts(tmp_path, case):
    path = str(tmp_path / f"{case}.jpg")
    img = _scene(45, 37, seed=3)
    if case == "gray":
        cv2.imwrite(path, img[..., 0])
    elif case == "restart":
        cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 90,
                                           cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
    elif case == "odd_tiny":
        Image.fromarray(_scene(3, 5)).save(path, quality=90, subsampling=2)
    else:
        f = {"h1v2": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
             "h4v1": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}[case]
        cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, f])
    _, unequal = _check(path, _libjpeg(path))
    assert unequal == 0
    if case == "restart":
        assert b"\xff\xdd" in open(path, "rb").read()       # a DRI segment


def test_exif_orientation_is_not_applied(tmp_path):
    """``dataio.cpp`` does not rotate by the EXIF tag; cv2.imread would."""
    img = _scene(20, 36)
    exif = Image.Exif()
    exif[0x0112] = 6                                        # rotate 90° CW
    path = str(tmp_path / "exif.jpg")
    Image.fromarray(img).save(path, quality=95, exif=exif.tobytes())
    assert cv2.imread(path).shape[:2] == (36, 20)           # cv2 applies it
    got, unequal = _check(path, _libjpeg(path))
    assert got.shape[:2] == (20, 36) and unequal == 0


def test_unsupported_files_raise_naming_the_file(tmp_path):
    prog = str(tmp_path / "prog.jpg")
    cv2.imwrite(prog, _scene(16, 16)[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="prog.jpg.*ROADMAP.*progressive JPEG"):
        jpeg.read(prog)
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(_scene(16, 16)).convert("CMYK").save(cmyk, quality=90)
    with pytest.raises(ValueError, match="cmyk.jpg.*CMYK"):
        jpeg.read(cmyk)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\x89PNG\r\n" + b"\0" * 20)
    with pytest.raises(ValueError, match="bad.jpg: not a JPEG"):
        jpeg.read(str(bad))


def test_write_jpeg_is_cv2_readable_at_cv2s_psnr(tmp_path):
    """Quality 95, 4:2:0: cv2 decodes the port's file to the source within
    0.1 dB of the PSNR its own encoder reaches (and above 40 dB on a smooth
    image); the port's decoder equals cv2's on the port's files."""
    for name, img in (("smooth", cv2.GaussianBlur(_scene(300, 400), (0, 0), 3)),
                      ("noisy", _scene(75, 101))):
        ours, theirs = str(tmp_path / f"{name}_p.jpg"), str(tmp_path / f"{name}_c.jpg")
        jpeg.write_jpeg(ours, img, quality=95)
        cv2.imwrite(theirs, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])

        def psnr(p):
            d = _libjpeg(p).astype(np.float64) - img
            return 10 * np.log10(255.0 ** 2 / (d ** 2).mean())

        assert psnr(ours) >= psnr(theirs) - 0.1, (name, psnr(ours), psnr(theirs))
        if name == "smooth":
            assert psnr(ours) > 40.0
        _, unequal = _check(ours, _libjpeg(ours))
        assert unequal == 0
        with Image.open(ours) as im:
            assert im.format == "JPEG" and im.size == img.shape[1::-1]
            assert [tuple(x)[1:] for x in im.layer] == [(2, 2, 0), (1, 1, 1), (1, 1, 1)]
    # an already-decoded buffer goes through ``decode`` as well
    buf = io.BytesIO()
    Image.fromarray(_scene(9, 9)).save(buf, format="JPEG", quality=80)
    np.testing.assert_array_equal(jpeg.decode(buf.getvalue()),
                                  np.asarray(Image.open(io.BytesIO(buf.getvalue()))))


def test_quality_scaling_is_libjpegs():
    base = np.array([16, 11, 99, 255])
    np.testing.assert_array_equal(jpeg.quality_table(base, 50), base)
    np.testing.assert_array_equal(jpeg.quality_table(base, 95), [2, 1, 10, 26])
    np.testing.assert_array_equal(jpeg.quality_table(base, 100), [1, 1, 1, 1])
    np.testing.assert_array_equal(jpeg.quality_table(base, 10), [80, 55, 255, 255])


@pytest.mark.parametrize("level", [1, 3])
def test_resample_load_reads_jpeg(tmp_path, level):
    img = _scene(30, 40, noise=5.0)
    path = str(tmp_path / "v.jpg")
    cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 95])
    dh, dw = 30 // level, 40 // level
    got = resample.load(path, dh, dw, scale=1.0 / 256.0)
    want = resample.resize_area(_libjpeg(path), dh, dw, 1.0 / 256.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def jpeg_scenes(tmp_path_factory):
    from customnerf_torch.data import fixtures
    root = tmp_path_factory.mktemp("jpeg_scenes")
    out = {}
    for data_type in ("nerfstudio", "llff"):
        src = fixtures.write(data_type, str(root), 8, 40, 30)
        out[data_type] = fixtures.jpeg_copy(src, src + "_jpeg")
    return out


@pytest.mark.parametrize("data_type", ["nerfstudio", "llff"])
def test_loaders_read_the_reference_layout(jpeg_scenes, data_type):
    """``.jpg`` images and ``.png`` masks: the port's provider equals the
    JAX provider (images to 1 level / 256, masks and rays to 1e-6)."""
    from customnerf_tpu import config as jconfig
    from customnerf_tpu.data import base as jbase
    from customnerf_torch import config as tconfig
    from customnerf_torch.data import base as tbase
    d = jpeg_scenes[data_type]
    assert all(f.endswith(".jpg") for f in os.listdir(os.path.join(d, "images")))
    assert all(f.endswith(".png") for f in os.listdir(os.path.join(d, "lang_bear")))
    if data_type == "nerfstudio":
        with open(os.path.join(d, "transforms.json")) as f:
            assert json.load(f)["frames"][0]["file_path"].endswith(".jpg")
    flags = (f"-O --data_type {data_type} --keyword lang_bear --data_path {d} "
             f"--train_resolution_level 2 --eval_resolution_level 3 --train_size 7").split()
    for split in ("train", "val"):
        j = jbase.NeRFDataset(jconfig.parse_args(flags), split).dataloader()
        t = tbase.NeRFDataset(tconfig.parse_args(flags), split, device="cpu").dataloader()
        assert (len(t), t.n_images, t.H, t.W, t.images_lis) == \
            (len(j), j.n_images, j.H, j.W, j.images_lis)
        assert t.images_lis[0].endswith(".jpg")
        for name, tol in (("images_flat", 1.0 / 256 + 1e-6), ("masks_flat", 1e-6),
                          ("origins_flat", 1e-5), ("directions_flat", 1e-5)):
            np.testing.assert_allclose(getattr(t, name).numpy(),
                                       np.asarray(getattr(j, name)),
                                       rtol=0, atol=tol, err_msg=name)
