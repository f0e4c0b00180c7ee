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
to the JAX providers, progressive images too, as does ``ConceptDataset``;
their thread pool (``resample.load_many``) gives each image in order,
equal to its own load.  A progressive file that is truncated or breaks
the progression raises, naming the file.

Every file these tests decode goes through both Huffman stages (the
autouse ``native_equals_plain``): the host library's coefficients
(``csrc/host/jpeg_entropy.cpp``) must equal the plain Python loops',
coefficient for coefficient, and both must fail alike on a bad file.

Block smoothing (files whose scans leave bits unsent): progressive files
written by cv2 with their last refinement scan dropped, with the luma's
AC-first scan (and the refinements after it) dropped, and with all AC
scans of one component dropped (the DC-interpolation branch), at 4:2:0,
4:4:4, gray and with a restart interval, decode bit for bit as the JAX
package's reader (``csrc/dataio.cpp`` on libjpeg-turbo 2.1.5) decodes them.
``cv2.imread`` (libjpeg-turbo 3.1) is the second witness: the two differ on
the 4:2:0 files only, where 3.1 takes the smoothing window's rows clamped
to the image while 2.1 repeats the nearer row at the first and the
second-to-last iMCU rows; the port with 3.1's row rule swapped in equals
cv2 bit for bit on every file.  A spectral-selection file (written here
from a cv2 file's coefficients) whose scans leave only coefficients 10-63
unsent decodes unsmoothed, equal to both witnesses."""

import io
import json
import math
import os
import struct
import time

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


_decode_coefficients = jpeg.decode_coefficients


@pytest.fixture(autouse=True)
def native_equals_plain(monkeypatch):
    """Every decode in these tests also runs the plain Python Huffman loops
    and holds the host library's coefficients (or its error) to theirs."""
    checked = []

    def both(data, name="<bytes>", plain=False):
        if plain:
            return _decode_coefficients(data, name, plain=True)
        try:
            f, coefs = _decode_coefficients(data, name)
        except ValueError as e:
            with pytest.raises(ValueError) as plain_error:
                _decode_coefficients(data, name, plain=True)
            assert str(plain_error.value) == str(e)
            raise
        _, want = _decode_coefficients(data, name, plain=True)
        assert len(coefs) == len(want)
        for a, b in zip(coefs, want):
            assert a.dtype == np.int32 and np.array_equal(a, b), name
        checked.append(name)
        return f, coefs

    monkeypatch.setattr(jpeg, "decode_coefficients", both)
    return checked


def _libjpeg(path):
    return cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)[..., ::-1]


def _native(path, h, w):
    from customnerf_tpu.utils import native
    if not native.has_image_codecs():
        return None
    out = native.decode_resize_batch([path], h, w, scale=1.0)
    return None if out is None else out[0]


def _jax_reader(path, h, w):
    """The JAX package's reader (``csrc/dataio.cpp`` on the system's
    libjpeg), the oracle of the smoothing tests: a build without its codecs
    fails them.  The library is built in place on first use, so a load that
    meets another test process's build half written is tried again."""
    from customnerf_tpu.utils import native
    for _ in range(3):
        if native.has_image_codecs():
            return native.decode_resize_batch([path], h, w, scale=1.0)[0]
        native._lib, native._tried = None, False
        time.sleep(2.0)
    pytest.fail("the JAX package's reader did not build with its image codecs "
                "(csrc/dataio.cpp, -ljpeg): the smoothing tests need it")


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


def test_progressive_truncated_or_incomplete_raises(tmp_path, native_equals_plain):
    """A file cut short raises; so does one whose last scan comes twice (a
    refinement of bits already sent).  One whose last scan was dropped (its
    EOI kept) leaves its coefficients' last bits unsent: it decodes as the
    JAX package's reader (libjpeg-turbo 2.1.5) decodes it, blocks smoothed
    (``jdcoefct.c``), and as cv2 (libjpeg-turbo 3.1) decodes it under 3.1's
    row rule (this file is 4:2:0)."""
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
    got = jpeg.read(str(short))
    assert str(short) in native_equals_plain
    assert jpeg.smoothing_latch(jpeg.decode_coefficients(short.read_bytes())[0]) is not None
    np.testing.assert_array_equal(got.astype(np.float32), _jax_reader(str(short), 40, 48))
    np.testing.assert_array_equal(_with_clamped_rows(str(short)), _libjpeg(str(short)))
    # the last scan sent twice refines bits that are known already
    twice = tmp_path / "twice.jpg"
    twice.write_bytes(data[:last[2]] + data[last[1]:])
    with pytest.raises(ValueError, match="twice.jpg.*breaks the progression"):
        jpeg.read(str(twice))


def _with_clamped_rows(path):
    orig = jpeg._smoothing_rows
    jpeg._smoothing_rows = jpeg._clamped_smoothing_rows
    try:
        return jpeg.read(path)
    finally:
        jpeg._smoothing_rows = orig


def _scan_info(data, seg):
    """(component ids, Ss, Se, Ah, Al) of the SOS segment ``seg``."""
    body = data[seg[1] + 4:]
    ns = body[0]
    return ([body[1 + 2 * i] for i in range(ns)], body[1 + 2 * ns], body[2 + 2 * ns],
            body[3 + 2 * ns] >> 4, body[3 + 2 * ns] & 15)


def _drop_scans(data, drop):
    """``data`` without the scans whose (ids, Ss, Se, Ah, Al) ``drop`` takes."""
    scans = [s for s in _segments(data) if s[0] == 0xDA]
    out = data
    for s in sorted((s for s in scans if drop(*_scan_info(data, s))), key=lambda s: -s[1]):
        out = out[:s[1]] + out[s[2]:]
    assert len(out) < len(data)
    return out


@pytest.mark.parametrize("drop", ["last_refinement", "luma_ac_first", "one_component_ac"])
@pytest.mark.parametrize("layout", ["420", "444", "gray", "restart"])
def test_smoothing_equals_the_jax_reader(tmp_path, layout, drop):
    """Scans dropped from a cv2 progressive file: every case smooths (the
    last three cases by DC interpolation), and equals the JAX package's
    reader bit for bit; cv2 under its own row rule too."""
    h, w = 61, 83
    img = _scene(h, w, seed=11)
    path = str(tmp_path / "full.jpg")
    if layout == "gray":
        _write_progressive(path, img[..., 0], "cv2", 90)
    else:
        _write_progressive(path, img, "cv2", 90, "420" if layout == "restart" else layout,
                           restart=2 if layout == "restart" else 0)
    data = open(path, "rb").read()
    infos = [_scan_info(data, s) for s in _segments(data) if s[0] == 0xDA]
    luma = infos[0][0][0]
    last = infos[-1]
    rules = {
        "last_refinement": lambda *i: i == last,
        # the luma's AC-first scan of 6-63 and every luma refinement after it
        "luma_ac_first": lambda ids, ss, se, ah, al: ids == [luma] and ss > 0
        and (ss > 1 or ah > 0),
        # every AC scan of the last-coded component (the luma when gray)
        "one_component_ac": lambda ids, ss, se, ah, al: ids == [last[0][0]] and ss > 0,
    }
    short = tmp_path / f"{layout}_{drop}.jpg"
    short.write_bytes(_drop_scans(data, rules[drop]))
    f, _ = jpeg.decode_coefficients(short.read_bytes())
    latch = jpeg.smoothing_latch(f)
    assert latch is not None
    assert (drop == "one_component_ac") == bool((latch[:, 1:] == -1).all(1).any())
    got = jpeg.read(str(short))
    np.testing.assert_array_equal(got.astype(np.float32), _jax_reader(str(short), h, w))
    np.testing.assert_array_equal(_with_clamped_rows(str(short)), _libjpeg(str(short)))
    if layout in ("444", "gray"):              # one block row an iMCU row: the same rule
        np.testing.assert_array_equal(got, _libjpeg(str(short)))


def _spectral_file(src_path, bands, keep_bands):
    """The coefficients of the file at ``src_path`` (the port's decode of
    them) re-sent by spectral selection only: one DC scan of all
    components, then one AC scan a component for each band (Ss, Se) of
    ``bands`` listed in ``keep_bands``, all with Al 0, coded with the Annex
    K luma tables."""
    f, coefs = jpeg.decode_coefficients(open(src_path, "rb").read())
    comps, (h, w) = f.comps, f.size
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    dc_codes, ac_codes = jpeg._codes(*jpeg._DC_LUMA), jpeg._codes(*jpeg._AC_LUMA)
    zz = [c.reshape(comp["bh_pad"], comp["bw_pad"], 64)[..., jpeg.ZIGZAG].astype(np.int64)
          for c, comp in zip(coefs, comps)]

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    def magnitude(v):
        s = abs(v).bit_length()
        return s, (v if v >= 0 else v + (1 << s) - 1)

    def scan(ids, ss, se, units):
        codes, lengths = [], []

        def put(code, n):
            codes.append(code)
            lengths.append(n)

        pred = {}
        for ci, blk in units:
            if ss == 0:
                diff = int(blk[0]) - pred.get(ci, 0)
                pred[ci] = int(blk[0])
                s, bits = magnitude(diff)
                put(*dc_codes[s])
                if s:
                    put(bits, s)
                continue
            run = 0
            for k in range(ss, se + 1):
                v = int(blk[k])
                if v == 0:
                    run += 1
                    continue
                while run > 15:
                    put(*ac_codes[0xF0])
                    run -= 16
                s, bits = magnitude(v)
                put(*ac_codes[(run << 4) | s])
                put(bits, s)
                run = 0
            if run:
                put(*ac_codes[0x00])                      # EOB: this block
        body = bytes([len(ids)]) + b"".join(bytes([comps[i]["id"], 0x00]) for i in ids)
        return seg(0xDA, body + bytes([ss, se, 0])) + jpeg._pack_bits(
            np.asarray(codes, np.int64), np.asarray(lengths, np.int64))

    def own_grid(ci):
        c = comps[ci]
        bw = math.ceil(math.ceil(w * c["h"] / hmax) / 8)
        bh = math.ceil(math.ceil(h * c["v"] / vmax) / 8)
        return [(ci, zz[ci][by, bx]) for by in range(bh) for bx in range(bw)]

    out = [b"\xff\xd8"]
    for tq, q in sorted(f.qt.items()):
        out.append(seg(0xDB, bytes([tq]) + bytes(q.reshape(-1)[jpeg.ZIGZAG].astype(np.uint8).tolist())))
    out.append(seg(0xC2, struct.pack(">BHHB", 8, h, w, len(comps)) + b"".join(
        bytes([c["id"], (c["h"] << 4) | c["v"], c["tq"]]) for c in comps)))
    out.append(seg(0xC4, bytes([0x00]) + bytes(jpeg._DC_LUMA[0]) + bytes(jpeg._DC_LUMA[1])))
    out.append(seg(0xC4, bytes([0x10]) + bytes(jpeg._AC_LUMA[0]) + bytes(jpeg._AC_LUMA[1])))
    if len(comps) == 1:
        dc_units = own_grid(0)
    else:
        mx, my = math.ceil(w / (8 * hmax)), math.ceil(h / (8 * vmax))
        dc_units = [(ci, zz[ci][r * c["v"] + by, q * c["h"] + bx])
                    for r in range(my) for q in range(mx)
                    for ci, c in enumerate(comps)
                    for by in range(c["v"]) for bx in range(c["h"])]
    out.append(scan(list(range(len(comps))), 0, 0, dc_units))
    for band in keep_bands:
        ss, se = bands[band]
        for ci in range(len(comps)):
            out.append(scan([ci], ss, se, own_grid(ci)))
    return b"".join(out + [b"\xff\xd9"])


@pytest.mark.parametrize("layout", ["420", "444", "gray"])
def test_unsent_bits_beyond_the_latch_decode_unsmoothed(tmp_path, layout):
    """Coefficients 0-9 complete, 10-63 never sent: ``smoothing_ok`` finds
    nothing useful, so libjpeg (both witnesses) decodes the missing bits as
    zeros; so does the port.  With every band sent, the file decodes as the
    baseline file it was made from."""
    h, w = 45, 70
    img = _scene(h, w, seed=12)
    src = str(tmp_path / "base.jpg")
    if layout == "gray":
        cv2.imwrite(src, img[..., 0], [cv2.IMWRITE_JPEG_QUALITY, 85])
    else:
        cv2.imwrite(src, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 85,
                                          cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                          SAMPLING[layout][0]])
    bands = [(1, 9), (10, 63)]
    whole, part = tmp_path / "whole.jpg", tmp_path / "part.jpg"
    whole.write_bytes(_spectral_file(src, bands, [0, 1]))
    part.write_bytes(_spectral_file(src, bands, [0]))
    np.testing.assert_array_equal(jpeg.read(str(whole)), jpeg.read(src))
    np.testing.assert_array_equal(jpeg.read(str(whole)), _libjpeg(str(whole)))
    f, _ = jpeg.decode_coefficients(part.read_bytes())
    assert all(b[10:] == [-1] * 54 and b[:10] == [0] * 10 for b in f.coef_bits)
    assert jpeg.smoothing_latch(f) is None
    got = jpeg.read(str(part))
    np.testing.assert_array_equal(got, _libjpeg(str(part)))
    np.testing.assert_array_equal(got.astype(np.float32), _jax_reader(str(part), h, w))
    assert not np.array_equal(got, jpeg.read(src))


def test_corrupted_entropy_data_fails_alike_in_both_stages(tmp_path, native_equals_plain):
    """Bytes flipped in the scans of baseline and progressive files (with
    restart intervals): the host library and the plain loops give the same
    coefficients or the same error, and nothing crashes."""
    rs = np.random.RandomState(13)
    files = []
    for prog in (False, True):
        path = str(tmp_path / f"src{int(prog)}.jpg")
        if prog:
            _write_progressive(path, _scene(33, 47), "cv2", 80, "420", restart=3)
        else:
            cv2.imwrite(path, _scene(33, 47)[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 80,
                                                          cv2.IMWRITE_JPEG_RST_INTERVAL, 3])
        files.append(open(path, "rb").read())
    outcomes = {"decoded": 0, "raised": 0}
    for data in files:
        scans = [s for s in _segments(data) if s[0] == 0xDA]
        for i in range(60):
            s = scans[i % len(scans)]
            start = s[1] + 2 + int.from_bytes(data[s[1] + 2:s[1] + 4], "big")
            at = int(rs.randint(start, s[2]))
            bad = bytearray(data)
            bad[at] ^= 1 << int(rs.randint(0, 8))
            try:
                jpeg.decode_coefficients(bytes(bad), f"flip{i}")
                outcomes["decoded"] += 1
            except ValueError as e:
                assert f"flip{i}" in str(e)
                outcomes["raised"] += 1
    assert outcomes["decoded"] and outcomes["raised"]
    assert len(native_equals_plain) == outcomes["decoded"]


# scan headers libjpeg refuses: (SOS body after Ns, or None for the
# original's, with Ns), the error both decoders give
_BAD_SOS = {
    "ns5_repeated": (5, bytes([1, 0x00, 2, 0x11, 3, 0x11, 1, 0x00, 1, 0x00]),
                     "scan header \\(Ns=5"),
    "repeated": (3, bytes([1, 0x00, 1, 0x00, 2, 0x11]), "component 1 twice"),
    "ns0": (0, b"", "scan header \\(Ns=0"),
    "length": (3, bytes([1, 0x00, 2, 0x11, 3, 0x11, 0]), "scan header \\(Ns=3"),
    "mcu_blocks": (3, None, "more than 10 blocks"),
}


@pytest.mark.parametrize("case", sorted(_BAD_SOS))
@pytest.mark.parametrize("prog", [False, True], ids=["baseline", "progressive"])
def test_malformed_scan_headers_raise_alike(tmp_path, native_equals_plain, prog, case):
    """The first scan's header replaced by one libjpeg's ``get_sos`` or
    ``per_scan_setup`` refuses (Ns above 4 with a component named again, a
    component named twice, Ns 0, a wrong length, and 12 blocks in an
    interleaved MCU from 2x2 factors in every component): both Huffman
    stages raise the same ``ValueError`` naming the file.  In the
    progressive file the new header is a DC-first scan with Al 0, which
    the progression rules alone let through.  The host library refuses a
    scan of more than 4 slots by itself too."""
    path = str(tmp_path / "src.jpg")
    img = _scene(32, 40)
    if prog:
        _write_progressive(path, img, "cv2", 80, "444")
    else:
        cv2.imwrite(path, img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, 80,
                                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                           SAMPLING["444"][0]])
    data = open(path, "rb").read()
    segs = _segments(data)
    sos = next(s for s in segs if s[0] == 0xDA)
    ns, comps, match = _BAD_SOS[case]
    if comps is None:                        # every component sampled 2x2
        sof = next(s for s in segs if s[0] in (0xC0, 0xC2))
        bad = bytearray(data)
        for i in range(3):
            bad[sof[1] + 4 + 6 + 3 * i + 1] = 0x22
        data = bytes(bad)
        comps = data[sos[1] + 5:sos[1] + 5 + 2 * ns]
    tail = bytes([0, 0, 0]) if prog else bytes([0, 63, 0])
    body = bytes([ns]) + comps + tail
    header = struct.pack(">BBH", 0xFF, 0xDA, len(body) + 2) + body
    start = sos[1] + 2 + int.from_bytes(data[sos[1] + 2:sos[1] + 4], "big")
    out = tmp_path / f"{case}.jpg"
    out.write_bytes(data[:sos[1]] + header + data[start:])
    with pytest.raises(ValueError, match=f"{case}.jpg: .*{match}"):
        jpeg.read(str(out))
    assert not native_equals_plain
    from customnerf_torch.utils import hostlib
    for slots in (0, 5, 255):
        assert hostlib.library().cn_jpeg_decode_scan(
            None, None, 0, slots, None, None, None, None, 0, 0, 0, 0, None, None,
            0, int(prog), 0, 0, 0, 0) == 3


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


def test_load_many_equals_loads_in_order(tmp_path):
    """The loaders' thread pool (``resample.load_many``): the images of
    mixed sizes, formats and scales in the jobs' order, each equal to its
    own ``load``."""
    jobs = []
    for i in range(9):
        img = _scene(20 + 3 * i, 30 + i, seed=i)
        path = str(tmp_path / f"v{i}.{'png' if i % 3 == 0 else 'jpg'}")
        if i % 3 == 0:
            png.write(path, img)
        elif i % 3 == 1:
            jpeg.write_jpeg(path, img)
        else:
            _write_progressive(path, img, "cv2")
        jobs.append((path, 10 + i, 15 + i))
    for kw in ({"scale": 1.0 / 256.0}, {"gray": True, "interp": "linear"}):
        got = resample.load_many(jobs, **kw)
        assert len(got) == len(jobs)
        for g, job in zip(got, jobs):
            np.testing.assert_array_equal(g, resample.load(*job, **kw))


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
