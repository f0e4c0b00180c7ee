"""The port's zstd frame decoder (``customnerf_torch/utils/zstd.py`` over
``csrc/host/zstd_decode.cpp``) against the ``zstandard`` package, byte for
byte: levels 1, 3 and 19 (and a negative "fast" level) on random bytes,
zeros, text, float32 arrays, skewed bytes and pieces of a history behind a
marker byte, so that raw, RLE and Huffman literals (one and four streams,
weights sent directly or FSE-coded, treeless repeats), and predefined,
RLE, FSE-compressed and repeat sequence tables with repeat offsets all
occur (checked once with a counting build of the decoder); windows above 128
KB, several frames and skippable frames in one buffer, frames with and
without a content size and a checksum; random buffers under ``hypothesis``.
Truncated and corrupted frames raise ``ValueError`` (or, where a flipped
bit changes nothing the frame checks, decode to the same bytes), never
crash.  Plus the CRC-32C that OCDBT frames carry, against its check value.
"""

import numpy as np
import pytest

from customnerf_torch.engine import ocdbt
from customnerf_torch.utils import zstd

zstandard = pytest.importorskip("zstandard")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402


def _inputs():
    rs = np.random.RandomState(0)
    text = open(zstd.__file__, "rb").read() + open(ocdbt.__file__, "rb").read()
    # after a 200 KB history of bytes < 100, copies of its pieces each behind
    # the byte 200: a later block's literals are all 200 (RLE literals at 19)
    hist = bytes(rs.randint(0, 100, 200_000, dtype=np.uint8))
    starts, lens = rs.randint(0, len(hist) - 100, 4000), rs.randint(20, 60, 4000)
    rle = hist + b"".join(b"\xc8" + hist[o:o + n] for o, n in zip(starts, lens))
    return {
        # few, skewed symbols: Huffman weights sent directly (4 bits each)
        "skewed": bytes(rs.geometric(0.3, 20_000).clip(0, 15).astype(np.uint8)),
        "rle_literals": rle,
        "random": rs.bytes(150_000),
        "zeros": bytes(400_000),
        "text": text * 6,
        "float32": rs.randn(120_000).astype(np.float32).tobytes(),
        "float32_smooth": np.cumsum(rs.randn(90_000)).astype(np.float32).tobytes(),
    }


INPUTS = _inputs()


def _roundtrip(data, **kw):
    frame = zstandard.ZstdCompressor(**kw).compress(data)
    got = zstd.decompress(frame)
    assert got.dtype == np.uint8
    assert got.tobytes() == data, (len(got), len(data))
    return frame


@pytest.mark.parametrize("name", sorted(INPUTS))
@pytest.mark.parametrize("level", [1, 3, 19, -5])
def test_matches_zstandard(level, name):
    _roundtrip(INPUTS[name], level=level, write_checksum=True)


def test_window_above_128k_and_long_matches():
    """A 1.5 MB input whose repeats lie 300 KB apart: matches reach back past
    one 128 KB block, through the window."""
    rs = np.random.RandomState(1)
    unit = rs.bytes(300_000)
    data = unit + bytes(rs.randint(0, 256, 1000, dtype=np.uint8)) + unit + unit[:500_000]
    for level in (3, 19):
        frame = _roundtrip(data, level=level)
        params = zstandard.get_frame_parameters(frame)
        assert params.window_size > 128 * 1024


def test_frames_without_content_size_skippable_and_several():
    data = INPUTS["text"]
    cctx = zstandard.ZstdCompressor(level=3, write_content_size=False)
    streamed = cctx.compress(data)
    assert zstandard.get_frame_parameters(streamed).content_size == \
        zstandard.CONTENTSIZE_UNKNOWN
    assert zstd.decompress(streamed).tobytes() == data
    # stream API: no content size in the header, several blocks
    chunks = cctx.compressobj()
    framed = chunks.compress(data) + chunks.flush()
    assert zstd.decompress(framed).tobytes() == data
    # several frames, a skippable frame between them
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    a = zstandard.ZstdCompressor(level=1, write_checksum=True).compress(INPUTS["float32"])
    b = zstandard.ZstdCompressor(level=19).compress(INPUTS["zeros"])
    c = zstandard.ZstdCompressor(level=3).compress(b"")
    got = zstd.decompress(a + skip + b + c + skip).tobytes()
    assert got == INPUTS["float32"] + INPUTS["zeros"]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.one_of(st.binary(max_size=300),
                          st.tuples(st.binary(min_size=1, max_size=40),
                                    st.integers(1, 60)).map(lambda t: t[0] * t[1])),
                max_size=40),
       st.sampled_from([1, 3, 9, 19, -3]), st.booleans())
def test_random_buffers(parts, level, checksum):
    data = b"".join(parts)
    _roundtrip(data, level=level, write_checksum=checksum)


def test_truncated_and_corrupted_frames_raise():
    rs = np.random.RandomState(2)
    data = INPUTS["text"][:60_000] + INPUTS["float32"][:40_000]
    for kw in ({"level": 1, "write_checksum": True}, {"level": 19, "write_checksum": True}):
        frame = zstandard.ZstdCompressor(**kw).compress(data)
        for cut in sorted(set(rs.randint(1, len(frame), 40).tolist()) | {1, 4, 5, len(frame) - 1}):
            with pytest.raises(ValueError, match="zstd"):
                zstd.decompress(frame[:cut], "cut")
        for _ in range(150):
            bad = bytearray(frame)
            i = int(rs.randint(0, len(bad)))
            bad[i] ^= 1 << int(rs.randint(0, 8))
            try:
                got = zstd.decompress(bytes(bad), "flipped")
            except ValueError as e:
                assert "flipped: zstd" in str(e)
            else:
                assert got.tobytes() == data
    with pytest.raises(ValueError, match="bad magic"):
        zstd.decompress(b"\x00" * 16)
    with pytest.raises(ValueError, match="no frame"):
        zstd.decompress(b"")


def test_crc32c():
    assert ocdbt.crc32c(b"123456789") == 0xE3069283          # the check value
    assert ocdbt.crc32c(b"") == 0
    rs = np.random.RandomState(3)
    data = rs.bytes(1001)
    # the table-driven loop agrees with the bitwise definition
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    assert ocdbt.crc32c(data) == crc ^ 0xFFFFFFFF
