"""The port's PNG codec (``utils/png.py``) and resamplers
(``utils/resample.py``) against cv2 on the CPU: decoded pixels equal
``cv2.imread``'s exactly for 8-bit gray, RGB and RGBA files cv2 wrote
(every row filter it chooses); cv2 reads the port's files back exactly;
unsupported files raise; the area and bilinear resamplers match
``cv2.resize``'s ``INTER_AREA`` / ``INTER_LINEAR`` on float images at
resolution levels 1, 4 and 7 within 1e-5, and the JAX package's native
decoder (``csrc/dataio.cpp``) on the same files within 1e-5.
"""

import struct
import zlib

import numpy as np
import pytest

from customnerf_torch.utils import png, resample

cv2 = pytest.importorskip("cv2")


def _image(shape, seed):
    """Noise with flat and graded bands, so cv2 picks several row filters."""
    rng = np.random.RandomState(seed)
    img = (rng.rand(*shape) * 255).astype(np.uint8)
    img[: shape[0] // 3] = img[: shape[0] // 3] // 64 * 64
    ramp = np.linspace(0, 255, shape[1]).astype(np.uint8)
    band = ramp[None, :, None] if img.ndim == 3 else ramp[None]
    img[shape[0] // 3: 2 * shape[0] // 3] = band
    return img


@pytest.mark.parametrize("shape", [(30, 40), (30, 40, 3), (30, 40, 4), (17, 23, 3)])
def test_decode_equals_cv2_imread(tmp_path, shape):
    img = _image(shape, sum(shape))
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)                        # cv2 stores BGR(A)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    got = png.read(path)
    if want.ndim == 3:
        want = want[..., [2, 1, 0] + ([3] if want.shape[-1] == 4 else [])]
    np.testing.assert_array_equal(got, want)
    assert png.dims(path) == shape[:2]


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4])
def test_decode_each_row_filter(tmp_path, filt):
    """A file written with one filter on every row (cv2 mixes them)."""
    img = _image((9, 11, 3), filt)
    raw = img.reshape(9, 33).astype(np.int64)
    prior = np.zeros(33, np.int64)
    rows = []
    for y in range(9):
        cur = raw[y]
        left = np.concatenate([np.zeros(3, np.int64), cur[:-3]])
        upleft = np.concatenate([np.zeros(3, np.int64), prior[:-3]])
        if filt == 0:
            pred = np.zeros(33, np.int64)
        elif filt == 1:
            pred = left
        elif filt == 2:
            pred = prior
        elif filt == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        rows.append(bytes([filt]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = cur
    path = str(tmp_path / "f.png")
    _write_raw(path, 11, 9, 8, 2, 0, b"".join(rows))
    np.testing.assert_array_equal(png.read(path), img)
    np.testing.assert_array_equal(cv2.imread(path)[..., ::-1], img)


def _write_raw(path, w, h, depth, color, interlace, raw):
    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(png.SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(30, 40), (30, 40, 3)])
def test_cv2_reads_the_ports_png_exactly(tmp_path, shape):
    img = _image(shape, 3)
    path = str(tmp_path / "b.png")
    png.write(path, img)
    got = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got if got.ndim == 2 else got[..., ::-1], img)
    np.testing.assert_array_equal(png.read(path), img)


def test_unsupported_files_raise(tmp_path):
    interlaced = str(tmp_path / "i.png")
    _write_raw(interlaced, 4, 4, 8, 2, 1, b"\0" * (4 * 13))
    with pytest.raises(ValueError, match="i.png: interlaced"):
        png.read(interlaced)
    deep = str(tmp_path / "d.png")
    cv2.imwrite(deep, (np.random.RandomState(0).rand(5, 6) * 65535).astype(np.uint16))
    with pytest.raises(ValueError, match="d.png.*16-bit"):
        png.read(deep)
    palette = str(tmp_path / "p.png")
    _write_raw(palette, 4, 4, 8, 3, 0, b"\0" * (4 * 5))
    with pytest.raises(ValueError, match="p.png.*palette"):
        png.read(palette)
    # a .jpg path goes to utils/jpeg.py (tests/test_torch_jpeg.py); a
    # progressive one decodes there as libjpeg decodes it, through each of
    # these entry points
    jpg = str(tmp_path / "photo.jpg")
    cv2.imwrite(jpg, _image((8, 8, 3), 0), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    want = cv2.imread(jpg, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)[..., ::-1]
    np.testing.assert_array_equal(png.read(jpg), want)
    assert png.dims(jpg) == (8, 8)
    np.testing.assert_allclose(resample.load(jpg, 4, 4),
                               resample.resize_area(want, 4, 4, 1.0 / 255.0),
                               rtol=0, atol=1e-6)
    gif = tmp_path / "x.png"
    gif.write_bytes(b"GIF89a" + b"\0" * 40)
    with pytest.raises(ValueError, match="x.png: not a PNG"):
        png.read(str(gif))


@pytest.mark.parametrize("level", [1, 4, 7])
def test_resamplers_match_cv2_resize(level):
    rng = np.random.RandomState(level)
    img = rng.rand(300, 400, 3).astype(np.float32)
    dh, dw = int(300 / level), int(400 / level)
    area = resample.resize_area(img, dh, dw)
    linear = resample.resize_bilinear(img, dh, dw)
    assert area.shape == linear.shape == (dh, dw, 3) and area.dtype == np.float32
    np.testing.assert_allclose(
        area, cv2.resize(img, (dw, dh), interpolation=cv2.INTER_AREA), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        linear, cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR), rtol=0, atol=1e-5)
    gray = img[..., 0]
    np.testing.assert_allclose(
        resample.resize_area(gray, dh, dw),
        cv2.resize(gray, (dw, dh), interpolation=cv2.INTER_AREA), rtol=0, atol=1e-5)


@pytest.mark.parametrize("level", [1, 4, 7])
def test_load_matches_the_native_decoder(tmp_path, level):
    """``resample.load`` against ``csrc/dataio.cpp``'s decode-and-resize, the
    path the JAX loaders take: RGB and BT.601 luma, area and bilinear."""
    from customnerf_tpu.utils import native
    if not native.has_image_codecs():
        pytest.skip("the native decoder was built without image codecs")
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, _image((60, 80, 3), level))
    dh, dw = int(60 / level), int(80 / level)
    for gray in (False, True):
        for interp in ("area", "linear"):
            want = native.decode_resize_batch([path], dh, dw, gray=gray,
                                              scale=1 / 256.0, interp=interp)[0]
            got = resample.load(path, dh, dw, gray=gray, scale=1 / 256.0, interp=interp)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
