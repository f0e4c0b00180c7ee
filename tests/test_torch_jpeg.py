"""The port's JPEG codec (``customnerf_torch/utils/jpeg.py``) against
libjpeg: ``cv2.imread(…, IMREAD_COLOR | IMREAD_IGNORE_ORIENTATION)`` and,
where its codec build loads, the JAX package's native decoder
(``csrc/dataio.cpp``, libjpeg with its defaults), on files written by
``cv2.imwrite`` and PIL at qualities 50-100 with 4:4:4, 4:2:2, 4:2:0,
4:4:0 and 4:1:1 sampling, odd sizes, grayscale and restart intervals,
baseline and progressive (``IMWRITE_JPEG_PROGRESSIVE``, PIL's
``progressive=True``).
Tolerance: 1 level, with the count of unequal pixels reported (the islow
IDCT, fancy upsampling and the fixed-point colour tables are libjpeg's, so
every case here is expected to be exact).  The encoder's files decode in
cv2 to the source within the PSNR cv2's own encoder reaches, and the
loaders read the reference layout (``.jpg`` images, ``.png`` masks) equal
to the JAX providers, progressive images too, as does ``ConceptDataset``.
A progressive file that is truncated or whose scans leave coefficient bits
unsent (libjpeg would smooth it) raises, naming the file."""

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
    # a progressive file is supported: it decodes as libjpeg decodes it
    prog = str(tmp_path / "prog.jpg")
    cv2.imwrite(prog, _scene(16, 16)[..., ::-1], [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    np.testing.assert_array_equal(jpeg.read(prog), _libjpeg(prog))
    cmyk = str(tmp_path / "cmyk.jpg")
    Image.fromarray(_scene(16, 16)).convert("CMYK").save(cmyk, quality=90)
    with pytest.raises(ValueError, match="cmyk.jpg.*CMYK"):
        jpeg.read(cmyk)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\x89PNG\r\n" + b"\0" * 20)
    with pytest.raises(ValueError, match="bad.jpg: not a JPEG"):
        jpeg.read(str(bad))


def _write_progressive(path, img, writer, quality=90, sampling="420", restart=0):
    """A progressive JPEG of ``img`` (uint8 [H, W, 3] RGB or [H, W] gray)."""
    if writer == "cv2":
        params = [cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, 1]
        if img.ndim == 3:
            params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling][0]]
        if restart:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        cv2.imwrite(path, img[..., ::-1] if img.ndim == 3 else img, params)
    else:
        Image.fromarray(img).save(path, quality=quality, progressive=True,
                                  **({"subsampling": SAMPLING[sampling][1]}
                                     if img.ndim == 3 else {}))
    data = open(path, "rb").read()
    assert b"\xff\xc2" in data and b"\xff\xc0" not in data   # SOF2, no SOF0
    return path


@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("writer", ["cv2", "pil"])
def test_progressive_decode_equals_libjpeg(tmp_path, writer, quality, sampling):
    """Bit for bit: every scan kind (DC first and refinement, AC first and
    refinement with end-of-band runs) over partial MCUs."""
    path = _write_progressive(str(tmp_path / "p.jpg"), _scene(61, 83, seed=quality),
                              writer, quality, sampling)
    got = jpeg.read(path)
    np.testing.assert_array_equal(got, _libjpeg(path))
    native = _native(path, 61, 83)
    if native is not None:
        np.testing.assert_array_equal(got.astype(np.float32), native)
    assert jpeg.dims(path) == (61, 83)


@pytest.mark.parametrize("case", ["gray_cv2", "gray_pil", "restart_420", "restart_444",
                                  "odd_33x17", "tiny_3x5", "one_block"])
def test_progressive_other_layouts(tmp_path, case):
    """Gray (DC and AC scans of one component), restart intervals (the DC
    predictors and the end-of-band run reset), odd and tiny sizes."""
    path = str(tmp_path / f"{case}.jpg")
    if case.startswith("gray"):
        _write_progressive(path, _scene(45, 37, seed=3)[..., 0], case[5:])
    elif case.startswith("restart"):
        _write_progressive(path, _scene(45, 37, seed=4), "cv2", 85, case[-3:], restart=2)
        assert b"\xff\xdd" in open(path, "rb").read()
    else:
        h, w = {"odd_33x17": (33, 17), "tiny_3x5": (3, 5), "one_block": (8, 8)}[case]
        _write_progressive(path, _scene(h, w, seed=5), "pil", 92, "420")
    np.testing.assert_array_equal(jpeg.read(path), _libjpeg(path))


def _segments(data):
    """(marker, start, end) of each segment, a scan's entropy-coded data
    counted in its SOS segment; the EOI last."""
    out, pos = [], 2
    while True:
        marker = data[pos + 1]
        if marker == 0xD9:
            return out + [(marker, pos, pos + 2)]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        if marker == 0xDA:
            while not (data[end] == 0xFF and data[end + 1] not in (0, *range(0xD0, 0xD8))):
                end += 1
        out.append((marker, pos, end))
        pos = end


def test_progressive_truncated_or_incomplete_raises(tmp_path):
    """A file cut short raises; so does one whose last scan was dropped
    (its EOI kept): its coefficients' last bits are unsent, and libjpeg
    would smooth its blocks (``jdcoefct.c``), which the port's decoder does
    not do; and one whose last scan comes twice (a refinement of bits
    already sent)."""
    full = _write_progressive(str(tmp_path / "full.jpg"), _scene(40, 48), "cv2", 90)
    data = open(full, "rb").read()
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[: len(data) // 2])
    with pytest.raises(ValueError, match="cut.jpg"):
        jpeg.read(str(cut))
    segs = _segments(data)
    scans = [s for s in segs if s[0] == 0xDA]
    assert len(scans) >= 6                       # DC, AC first and refinement scans
    last = scans[-1]
    short = tmp_path / "short.jpg"
    short.write_bytes(data[:last[1]] + data[last[2]:])
    assert cv2.imread(str(short)) is not None    # libjpeg decodes it (smoothed)
    with pytest.raises(ValueError, match="short.jpg.*unsent.*ROADMAP.*progressive JPEG"):
        jpeg.read(str(short))
    # the last scan sent twice refines bits that are known already
    twice = tmp_path / "twice.jpg"
    twice.write_bytes(data[:last[2]] + data[last[1]:])
    with pytest.raises(ValueError, match="twice.jpg.*breaks the progression"):
        jpeg.read(str(twice))


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


@pytest.fixture(scope="module")
def progressive_scene(tmp_path_factory):
    """The nerfstudio fixture in the reference layout with its images as
    progressive JPEGs written by cv2."""
    from customnerf_torch.data import fixtures
    root = tmp_path_factory.mktemp("progressive_scene")
    src = fixtures.write("nerfstudio", str(root), 8, 40, 30)
    dst = fixtures.jpeg_copy(src, src + "_jpeg")
    for name in sorted(os.listdir(os.path.join(dst, "images"))):
        rgb = png.read_rgb(os.path.join(src, "images", name[:-4] + ".png"))
        _write_progressive(os.path.join(dst, "images", name), rgb, "cv2", 95)
    return dst


def test_loaders_read_progressive_images(progressive_scene):
    """The port's nerfstudio provider on progressive images equals the JAX
    provider (libjpeg): images to 1 level / 256 (the same decode; the
    resize's rounding), masks and rays to 1e-6."""
    from customnerf_tpu import config as jconfig
    from customnerf_tpu.data import base as jbase
    from customnerf_torch import config as tconfig
    from customnerf_torch.data import base as tbase
    d = progressive_scene
    flags = (f"-O --data_type nerfstudio --keyword lang_bear --data_path {d} "
             f"--train_resolution_level 2 --eval_resolution_level 3 --train_size 7").split()
    for split in ("train", "val"):
        j = jbase.NeRFDataset(jconfig.parse_args(flags), split).dataloader()
        t = tbase.NeRFDataset(tconfig.parse_args(flags), split, device="cpu").dataloader()
        assert (len(t), t.n_images, t.H, t.W, t.images_lis) == \
            (len(j), j.n_images, j.H, j.W, j.images_lis)
        for name, tol in (("images_flat", 1.0 / 256 + 1e-6), ("masks_flat", 1e-6),
                          ("origins_flat", 1e-5), ("directions_flat", 1e-5)):
            np.testing.assert_allclose(getattr(t, name).numpy(),
                                       np.asarray(getattr(j, name)),
                                       rtol=0, atol=tol, err_msg=name)


def test_concept_dataset_reads_progressive_images(tmp_path):
    """``ConceptDataset`` on progressive concept and class images (sizes
    below and above 512) equals the JAX one (``cv2.imread``), draw for draw:
    the rule of ``tests/test_torch_custom_diffusion.py``."""
    from customnerf_tpu.guidance import custom_diffusion as jcd
    from customnerf_torch.guidance import custom_diffusion as tcd
    for sub, sizes in (("inst", [(300, 280), (600, 640)]), ("cls", [(520, 530)])):
        os.makedirs(tmp_path / sub)
        for i, (h, w) in enumerate(sizes):
            img = cv2.GaussianBlur(_scene(h, w, seed=i), (0, 0), 2)
            _write_progressive(str(tmp_path / sub / f"c{i}.jpg"), img,
                               "cv2" if i % 2 else "pil", 90)
    args = (str(tmp_path / "inst"), "photo of a <new1> bear", str(tmp_path / "cls"), "bear")
    j, t = jcd.ConceptDataset(*args, size=512, seed=3), tcd.ConceptDataset(*args, size=512, seed=3)
    assert t.instance == j.instance and t.cls == j.cls
    for _ in range(6):
        (jc, jm, jp), (tc, tm, tp) = j.sample_instance(), t.sample_instance()
        assert tp == jp
        np.testing.assert_array_equal(tm, jm)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1.0 / 127.5 + 1e-6)
    (jc, jm, _), (tc, tm, _) = j.sample_class(), t.sample_class()
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1.0 / 127.5 + 1e-6)
