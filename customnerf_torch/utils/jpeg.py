"""JPEG decode (baseline and progressive) and baseline encode in numpy: the
port's stand-in for ``cv2.imread`` / ``cv2.imwrite`` on JPEG files, so that
it depends on neither ``cv2`` nor PIL.

The decoder gives what the JAX package's native reader gives
(``csrc/dataio.cpp:147-171``: libjpeg with its defaults and
``out_color_space = JCS_RGB``), which is what libjpeg itself computes:

  * markers SOI, DQT (8- and 16-bit tables), SOF0/SOF1/SOF2 at 8 bits, DHT
    (also between scans), SOS, DRI with RSTn, EOI; APPn and COM segments are
    skipped, so an EXIF orientation is not applied (``cv2.imread`` applies
    it, ``dataio.cpp`` does not); :func:`exif_orientation` reads the tag
    and :func:`orient` applies it as ``cv2.imread`` does, for the callers
    that read as cv2 does (Custom Diffusion's concept images);
  * Huffman decoding of sequential scans (interleaved or one component a
    scan) with 0xFF00 unstuffing, the DC predictors reset at each restart;
  * progressive scans (ITU-T T.81 Annex G.1.2, libjpeg's ``jdphuff.c``): DC
    first and DC refinement (interleaved or not), AC first with end-of-band
    runs, AC refinement with correction bits (one component a scan); a
    restart resets the DC predictors and the end-of-band run.  Every scan
    adds its bits to the same coefficients, which then go through the same
    reconstruction as a sequential file's;
  * dequantisation and libjpeg's integer "islow" IDCT (``jidctint.c``:
    CONST_BITS 13, PASS1_BITS 2, rounding descales, the range-limit table
    indexed modulo 1024), over all blocks of a component at once;
  * "fancy" triangle upsampling of the chroma planes for h2v1, h2v2 and, as
    libjpeg-turbo does it, h1v2 (``jdsample.c``), with the edge rows and
    columns replicated; other integral factors replicate samples;
  * libjpeg's fixed-point YCbCr → RGB tables (``jdcolor.c``, SCALEBITS 16);
    one-component files come back with the gray replicated to RGB, and
    three-component files that JFIF/Adobe markers or component ids mark as
    RGB are returned as they are.

Arithmetic-coded, lossless, hierarchical, 12-bit and CMYK files raise
``ValueError`` naming the file.  So do a progressive file without its EOI
(truncated), one whose scans break the progression rules, and one whose
scans leave a coefficient's bits unsent: libjpeg smooths such a file's
blocks (``jdcoefct.c``, block smoothing), which this decoder does not do;
that error names the ROADMAP row.  Huffman decoding runs symbol by symbol in
Python (a 16-bit lookup table a code, one window read a symbol), which is
the decoder's cost; the IDCT, upsampling and colour conversion are numpy.

:func:`write_jpeg` is a baseline encoder with ``cv2.imwrite``'s defaults:
4:2:0 sampling, the Annex K quantisation tables scaled as libjpeg's
``jpeg_quality_scaling`` scales them, and the Annex K Huffman tables.
"""

from __future__ import annotations

import math
import os
import struct

import numpy as np

PROGRESSIVE_ITEM = "progressive JPEG"


def _zigzag() -> np.ndarray:
    """Zigzag position → natural (row-major) index in an 8×8 block."""
    order = []
    for s in range(15):
        rows = range(min(s, 7), max(-1, s - 8), -1) if s % 2 == 0 else \
            range(max(0, s - 7), min(s, 7) + 1)
        order += [r * 8 + (s - r) for r in rows]
    return np.array(order, np.int64)


ZIGZAG = _zigzag()

# ------------------------------------------------------------ islow IDCT
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172


def _range_limit_table() -> np.ndarray:
    """``jdmaster.c::prepare_range_limit_table`` as the IDCT indexes it:
    the descaled sample x (centred on 0) reads entry ``x & 1023``."""
    t = np.zeros(1024, np.uint8)
    t[:128] = np.arange(128, 256)
    t[128:512] = 255
    t[896:] = np.arange(128)
    return t


_RANGE_LIMIT = _range_limit_table()


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x, axis: int):
    """One islow pass along ``axis`` (length 8) of int64 ``x``: the eight
    outputs before their descale, stacked back along ``axis``."""
    c = [np.take(x, k, axis=axis) for k in range(8)]
    # even part
    z1 = (c[2] + c[6]) * FIX_0_541196100
    tmp2 = z1 - c[6] * FIX_1_847759065
    tmp3 = z1 + c[2] * FIX_0_765366865
    tmp0 = (c[0] + c[4]) << CONST_BITS
    tmp1 = (c[0] - c[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    # odd part
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    out = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
           tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack(out, axis=axis)


def idct_islow(coef: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """int [N, 8, 8] quantised coefficients (natural order, [row, col]) and
    the [8, 8] quantisation table → uint8 [N, 8, 8] samples."""
    x = coef.astype(np.int64) * qtable.astype(np.int64)[None]
    ws = _descale(_idct_1d(x, axis=1), CONST_BITS - PASS1_BITS)      # columns
    out = _descale(_idct_1d(ws, axis=2), CONST_BITS + PASS1_BITS + 3)  # rows
    return _RANGE_LIMIT[out & 1023]


# ------------------------------------------------------------- upsampling
def _h2v1_fancy(p):
    """``jdsample.c::h2v1_fancy_upsample``: 3/4 nearer + 1/4 further, with
    biases 1 (left output) and 2 (right output)."""
    p = p.astype(np.int32)
    left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
    right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
    out = np.empty((p.shape[0], 2 * p.shape[1]), np.int32)
    out[:, 0::2] = (3 * p + left + 1) >> 2
    out[:, 1::2] = (3 * p + right + 2) >> 2
    return out


def _vertical_sums(p):
    """Column sums 3·nearer + further for the output rows above (from the
    row above) and below (from the row below) each input row."""
    p = p.astype(np.int32)
    up = np.concatenate([p[:1], p[:-1]], axis=0)
    down = np.concatenate([p[1:], p[-1:]], axis=0)
    return 3 * p + up, 3 * p + down


def _h1v2_fancy(p):
    """libjpeg-turbo's ``h1v2_fancy_upsample``: biases 1 (above) and 2."""
    a, b = _vertical_sums(p)
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int32)
    out[0::2] = (a + 1) >> 2
    out[1::2] = (b + 2) >> 2
    return out


def _h2v2_fancy(p):
    """``jdsample.c::h2v2_fancy_upsample``: the vertical sums, then
    (3·this + last + 8) >> 4 and (3·this + next + 7) >> 4 along the row."""
    out = np.empty((2 * p.shape[0], 2 * p.shape[1]), np.int32)
    for r, colsum in enumerate(_vertical_sums(p)):
        last = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
        nxt = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
        out[r::2, 0::2] = (3 * colsum + last + 8) >> 4
        out[r::2, 1::2] = (3 * colsum + nxt + 7) >> 4
    return out


def _upsample(p, rh: int, rv: int):
    """A component's plane [dh, dw] → [dh·rv, dw·rh], as libjpeg's
    ``jinit_upsampler`` chooses the method."""
    if rh == 1 and rv == 1:
        return p.astype(np.int32)
    if rh == 2 and rv == 1 and p.shape[1] > 2:
        return _h2v1_fancy(p)
    if rh == 1 and rv == 2:
        return _h1v2_fancy(p)
    if rh == 2 and rv == 2 and p.shape[1] > 2:
        return _h2v2_fancy(p)
    return np.repeat(np.repeat(p.astype(np.int32), rv, axis=0), rh, axis=1)


# ------------------------------------------------------------ YCbCr → RGB
def _color_tables():
    """``jdcolor.c::build_ycc_rgb_table`` (SCALEBITS 16)."""
    one_half = 1 << 15
    x = np.arange(256, dtype=np.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    return cr_r, cb_b, cr_g, cb_g


_CR_R, _CB_B, _CR_G, _CB_G = _color_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """uint8-valued planes → uint8 [H, W, 3]."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


# --------------------------------------------------------------- parsing
def _huffman_lut(bits, vals, name):
    """A 16-bit lookahead table: entry = (code length << 8) | symbol, or 0
    where no code of ≤ 16 bits starts."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if k >= len(vals):
                raise ValueError(f"{name}: bad Huffman table")
            span = 1 << (16 - length)
            start = code << (16 - length)
            if start + span > 1 << 16:
                raise ValueError(f"{name}: bad Huffman table")
            lut[start:start + span] = (length << 8) | vals[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


class _Frame:
    def __init__(self):
        self.qt = {}
        self.dc, self.ac = {}, {}
        self.restart = 0
        self.comps = None
        self.size = None
        self.jfif = False
        self.adobe = None
        self.progressive = False
        self.coef_bits = None        # progressive: per component, per zigzag
                                     # position, the bits still unsent (-1: none sent)


def _sof(f: _Frame, body: bytes, marker: int, name: str):
    if marker not in (0xC0, 0xC1, 0xC2):
        kind = ("arithmetic-coded" if marker >= 0xC9 else
                "lossless" if marker in (0xC3, 0xC7) else "hierarchical")
        raise ValueError(f"{name}: {kind} JPEG (SOF{marker - 0xC0}) is not supported")
    precision, h, w, n = struct.unpack(">BHHB", body[:6])
    if precision != 8:
        raise ValueError(f"{name}: {precision}-bit JPEG is not supported (8-bit only)")
    if n not in (1, 3):
        raise ValueError(f"{name}: JPEG with {n} components "
                         f"({'CMYK' if n == 4 else 'unsupported'}) is not supported")
    if h == 0 or w == 0:
        raise ValueError(f"{name}: JPEG without a frame height (DNL) is not supported")
    comps = []
    for i in range(n):
        cid, hv, tq = body[6 + 3 * i: 9 + 3 * i]
        comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
    f.comps, f.size = comps, (h, w)
    f.progressive = marker == 0xC2


def _next_segment(data: bytes, pos: int, name: str):
    """The marker segment at ``pos``: (marker, body, offset after it).
    Fill bytes are skipped, and so are standalone markers other than EOI."""
    n = len(data)
    while True:
        if pos >= n or data[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt or truncated JPEG (no marker at byte {pos})")
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise ValueError(f"{name}: truncated JPEG (no EOI marker)")
        marker = data[pos]
        pos += 1
        if marker == 0xD9:
            return marker, b"", pos
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        length = struct.unpack(">H", data[pos:pos + 2])[0]
        return marker, data[pos + 2:pos + length], pos + length


def _scan_extent(buf: np.ndarray, start: int):
    """The entropy-coded data of the scan starting at ``start``: a list of
    unstuffed segments (split at RSTn) and the offset of the marker that
    ends it."""
    seg = buf[start:]
    ffs = np.flatnonzero(seg[:-1] == 0xFF)
    nxt = seg[ffs + 1]
    is_rst = (nxt >= 0xD0) & (nxt <= 0xD7)
    ends = ffs[(nxt != 0) & ~is_rst & (nxt != 0xFF)]
    end = int(ends[0]) if len(ends) else len(seg)
    keep = ffs < end
    ffs, nxt, is_rst = ffs[keep], nxt[keep], is_rst[keep]
    cuts = [-2] + ffs[is_rst].tolist() + [end]
    stuffed = ffs[nxt == 0] + 1                          # the 0x00 after 0xFF
    parts = []
    for a, b in zip(cuts[:-1], cuts[1:]):
        lo = a + 2
        drop = stuffed[(stuffed >= lo) & (stuffed < b)]
        parts.append(np.delete(seg[lo:b], drop - lo))
    return parts, start + end


def _windows(part: np.ndarray):
    """Big-endian 32-bit windows at every byte of ``part`` (zero-padded):
    the next bits at bit position p are ``w[p >> 3] << (p & 7)``."""
    b = np.concatenate([part, np.zeros(8, np.uint8)]).astype(np.int64)
    w = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    return w.tolist()


def _mcu_layout(f: _Frame, scan):
    """(number of MCUs, MCU index → its blocks as (scan slot, block row,
    block column)): one block an MCU over the component's own block grid
    for a one-component scan, the frame's MCU grid otherwise."""
    hmax = max(c["h"] for c in f.comps)
    vmax = max(c["v"] for c in f.comps)
    h_img, w_img = f.size
    if len(scan) == 1:
        c = f.comps[scan[0][0]]
        bw = math.ceil(math.ceil(w_img * c["h"] / hmax) / 8)
        bh = math.ceil(math.ceil(h_img * c["v"] / vmax) / 8)
        return bw * bh, lambda m: ((0, m // bw, m % bw),)
    mx = math.ceil(w_img / (8 * hmax))
    my = math.ceil(h_img / (8 * vmax))
    layout = [(k, by, bx) for k, (ci, _, _) in enumerate(scan)
              for by in range(f.comps[ci]["v"]) for bx in range(f.comps[ci]["h"])]

    def mcu_blocks(m):
        r, q = divmod(m, mx)
        return tuple((k, r * f.comps[scan[k][0]]["v"] + by,
                      q * f.comps[scan[k][0]]["h"] + bx) for k, by, bx in layout)
    return mx * my, mcu_blocks


def _decode_scan(f: _Frame, scan, parts, coefs, name):
    """Huffman-decode one sequential scan into ``coefs`` (per component: a
    flat list of its padded block grid's coefficients, natural order)."""
    zz = ZIGZAG.tolist()
    n_mcu, mcu_blocks = _mcu_layout(f, scan)
    tables = []
    for ci, td, ta in scan:
        if td not in f.dc or ta not in f.ac:
            raise ValueError(f"{name}: scan uses an undefined Huffman table")
        c = f.comps[ci]
        tables.append((f.dc[td], f.ac[ta], coefs[ci], c["bw_pad"]))
    per_part = f.restart if f.restart else n_mcu
    m = 0
    for part in parts:
        if m >= n_mcu:
            break
        w = _windows(part)
        p = 0
        pred = [0] * len(scan)
        for _ in range(min(per_part, n_mcu - m)):
            for k, by, bx in mcu_blocks(m):
                dc, ac, out, bw_pad = tables[k]
                base = (by * bw_pad + bx) * 64
                e = dc[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not e:
                    raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
                p += e >> 8
                s = e & 0xFF
                diff = 0
                if s:
                    diff = (w[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                    p += s
                    if diff < (1 << (s - 1)):
                        diff -= (1 << s) - 1
                pred[k] += diff
                out[base] = pred[k]
                j = 1
                while j < 64:
                    e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError(f"{name}: corrupt JPEG data (bad Huffman code)")
                    p += e >> 8
                    rs = e & 0xFF
                    s = rs & 15
                    if s:
                        j += rs >> 4
                        v = (w[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                        p += s
                        if v < (1 << (s - 1)):
                            v -= (1 << s) - 1
                        if j < 64:
                            out[base + zz[j]] = v
                        j += 1
                    elif rs == 0xF0:
                        j += 16
                    else:
                        break
            m += 1


def _check_progression(f: _Frame, scan, ss, se, ah, al, name):
    """libjpeg's ``start_pass_phuff_decoder`` checks, every one fatal here
    (libjpeg only warns about a refinement whose Ah is not the bits left):
    then the scan's coefficients are marked as known down to bit Al."""
    bad = (se != 0 if ss == 0 else (ss > se or se > 63 or len(scan) != 1)) \
        or (ah != 0 and al != ah - 1) or al > 13
    if f.coef_bits is None:
        f.coef_bits = [[-1] * 64 for _ in f.comps]
    for ci, _, _ in scan:
        bits = f.coef_bits[ci]
        if ss > 0 and bits[0] < 0:
            bad = True                   # an AC scan before the DC's first
        for k in range(ss, min(se, 63) + 1):
            if ah != max(bits[k], 0):
                bad = True
            bits[k] = al
    if bad:
        raise ValueError(f"{name}: corrupt progressive JPEG (scan Ss={ss} Se={se} "
                         f"Ah={ah} Al={al} breaks the progression)")


def _decode_progressive_scan(f: _Frame, scan, ss, se, ah, al, parts, coefs, name):
    """Huffman-decode one progressive scan into ``coefs`` (libjpeg's
    ``jdphuff.c``: ``decode_mcu_DC_first``, ``_DC_refine``, ``_AC_first``,
    ``_AC_refine``); coefficients of later scans add their bits to what
    earlier scans left."""
    # natural order, with libjpeg's 16 guard entries (jpeg_natural_order)
    zz = ZIGZAG.tolist() + [63] * 16
    n_mcu, mcu_blocks = _mcu_layout(f, scan)
    outs = [coefs[ci] for ci, _, _ in scan]
    bw_pads = [f.comps[ci]["bw_pad"] for ci, _, _ in scan]
    if ss == 0 and ah == 0:
        if any(td not in f.dc for _, td, _ in scan):
            raise ValueError(f"{name}: scan uses an undefined Huffman table")
        dcs = [f.dc[td] for _, td, _ in scan]
    elif ss > 0:
        if scan[0][2] not in f.ac:
            raise ValueError(f"{name}: scan uses an undefined Huffman table")
        ac = f.ac[scan[0][2]]
    p1, m1 = 1 << al, -1 << al
    bad_code = f"{name}: corrupt JPEG data (bad Huffman code)"
    per_part = f.restart if f.restart else n_mcu
    m = 0
    for part in parts:
        if m >= n_mcu:
            break
        w = _windows(part)
        p = 0
        pred = [0] * len(scan)
        eobrun = 0
        for _ in range(min(per_part, n_mcu - m)):
            for slot, by, bx in mcu_blocks(m):
                out = outs[slot]
                base = (by * bw_pads[slot] + bx) * 64
                if ss == 0 and ah == 0:                          # DC first
                    e = dcs[slot][(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError(bad_code)
                    p += e >> 8
                    s = e & 0xFF
                    diff = 0
                    if s:
                        diff = (w[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                        p += s
                        if diff < (1 << (s - 1)):
                            diff -= (1 << s) - 1
                    pred[slot] += diff
                    out[base] = pred[slot] << al
                elif ss == 0:                                    # DC refinement
                    if (w[p >> 3] >> (31 - (p & 7))) & 1:
                        out[base] |= p1
                    p += 1
                elif ah == 0:                                    # AC first
                    if eobrun:
                        eobrun -= 1
                        continue
                    k = ss
                    while k <= se:
                        e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError(bad_code)
                        p += e >> 8
                        r, s = (e >> 4) & 15, e & 15
                        if s:
                            k += r
                            v = (w[p >> 3] >> (32 - s - (p & 7))) & ((1 << s) - 1)
                            p += s
                            if v < (1 << (s - 1)):
                                v -= (1 << s) - 1
                            out[base + zz[k]] = v << al
                        elif r == 15:                            # ZRL
                            k += 15
                        else:                                    # EOBr
                            eobrun = 1 << r
                            if r:
                                eobrun += (w[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                                p += r
                            eobrun -= 1
                            break
                        k += 1
                else:                                            # AC refinement
                    k = ss
                    if not eobrun:
                        while k <= se:
                            e = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                            if not e:
                                raise ValueError(bad_code)
                            p += e >> 8
                            r, s = (e >> 4) & 15, e & 15
                            if s:                # a newly nonzero coefficient: ±1 << Al
                                s = p1 if (w[p >> 3] >> (31 - (p & 7))) & 1 else m1
                                p += 1
                            elif r != 15:        # EOBr; the rest by the EOB run below
                                eobrun = 1 << r
                                if r:
                                    eobrun += (w[p >> 3] >> (32 - r - (p & 7))) & ((1 << r) - 1)
                                    p += r
                                break
                            # pass r zero coefficients, a correction bit for
                            # each nonzero one on the way
                            while k <= se:
                                pos = base + zz[k]
                                c = out[pos]
                                if c:
                                    if (w[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                                        out[pos] = c + p1 if c >= 0 else c + m1
                                    p += 1
                                elif r == 0:
                                    break
                                else:
                                    r -= 1
                                k += 1
                            if s:
                                out[base + zz[k]] = s
                            k += 1
                    if eobrun:
                        while k <= se:
                            pos = base + zz[k]
                            c = out[pos]
                            if c:
                                if (w[p >> 3] >> (31 - (p & 7))) & 1 and not c & p1:
                                    out[pos] = c + p1 if c >= 0 else c + m1
                                p += 1
                            k += 1
                        eobrun -= 1
            m += 1


def _read_tables(f: _Frame, marker: int, body: bytes, name: str):
    if marker == 0xDB:
        pos = 0
        while pos < len(body):
            pq, tq = body[pos] >> 4, body[pos] & 15
            n = 128 if pq else 64
            raw = body[pos + 1:pos + 1 + n]
            q = (np.frombuffer(raw, ">u2") if pq else np.frombuffer(raw, np.uint8))
            table = np.zeros(64, np.int64)
            table[ZIGZAG] = q
            f.qt[tq] = table.reshape(8, 8)
            pos += 1 + n
    elif marker == 0xC4:
        pos = 0
        while pos < len(body):
            tc, th = body[pos] >> 4, body[pos] & 15
            bits = list(body[pos + 1:pos + 17])
            n = sum(bits)
            vals = list(body[pos + 17:pos + 17 + n])
            (f.ac if tc else f.dc)[th] = _huffman_lut(bits, vals, name)
            pos += 17 + n
    elif marker == 0xDD:
        f.restart = struct.unpack(">H", body[:2])[0]
    elif marker == 0xE0 and body[:5] == b"JFIF\0":
        f.jfif = True
    elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
        f.adobe = body[11]
    elif marker == 0xCC:
        raise ValueError(f"{name}: arithmetic-coded JPEG is not supported")
    elif 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
        _sof(f, body, marker, name)


def _is_rgb(f: _Frame) -> bool:
    """libjpeg's ``default_decompress_parms`` guess for 3 components."""
    if f.jfif:
        return False
    if f.adobe is not None:
        return f.adobe == 0
    ids = [c["id"] for c in f.comps]
    return ids == [ord("R"), ord("G"), ord("B")]


def decode(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes → uint8 [H, W, 3] RGB."""
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    buf = np.frombuffer(data, np.uint8)
    f = _Frame()
    coefs = None
    pos = 2
    while pos < len(data):
        marker, body, end = _next_segment(data, pos, name)
        if marker == 0xD9:
            break
        pos = end
        if marker != 0xDA:
            _read_tables(f, marker, body, name)
            continue
        if f.comps is None:
            raise ValueError(f"{name}: scan before the frame header")
        if coefs is None:
            hmax = max(c["h"] for c in f.comps)
            vmax = max(c["v"] for c in f.comps)
            mx = math.ceil(f.size[1] / (8 * hmax))
            my = math.ceil(f.size[0] / (8 * vmax))
            for c in f.comps:
                c["bw_pad"], c["bh_pad"] = mx * c["h"], my * c["v"]
            coefs = [[0] * (c["bh_pad"] * c["bw_pad"] * 64) for c in f.comps]
        ns = body[0]
        ids = [c["id"] for c in f.comps]
        scan = []
        for i in range(ns):
            cid, t = body[1 + 2 * i], body[2 + 2 * i]
            if cid not in ids:
                raise ValueError(f"{name}: scan names an unknown component")
            scan.append((ids.index(cid), t >> 4, t & 15))
        ss, se, a = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
        if f.progressive:
            _check_progression(f, scan, ss, se, a >> 4, a & 15, name)
        elif ss != 0 or se != 63:
            raise ValueError(f"{name}: a spectral-selection scan is not baseline")
        parts, pos = _scan_extent(buf, end)
        try:
            if f.progressive:
                _decode_progressive_scan(f, scan, ss, se, a >> 4, a & 15, parts,
                                         coefs, name)
            else:
                _decode_scan(f, scan, parts, coefs, name)
        except IndexError:
            raise ValueError(f"{name}: corrupt JPEG data (scan ends early)") from None
    else:
        if f.progressive:
            raise ValueError(f"{name}: truncated progressive JPEG (no EOI marker)")
    if coefs is None:
        raise ValueError(f"{name}: JPEG without image data")
    if f.progressive and any(b != 0 for bits in f.coef_bits for b in bits):
        raise ValueError(
            f"{name}: progressive JPEG whose scans leave coefficient bits unsent; "
            f"libjpeg would smooth its blocks, which the port's decoder does not "
            f"(ROADMAP.md, row '{PROGRESSIVE_ITEM}')")
    return _reconstruct(f, coefs, name)


def _reconstruct(f: _Frame, coefs, name: str) -> np.ndarray:
    h_img, w_img = f.size
    hmax = max(c["h"] for c in f.comps)
    vmax = max(c["v"] for c in f.comps)
    planes = []
    for c, flat in zip(f.comps, coefs):
        if c["tq"] not in f.qt:
            raise ValueError(f"{name}: component uses an undefined quantisation table")
        if hmax % c["h"] or vmax % c["v"]:
            raise ValueError(f"{name}: fractional sampling factors are not supported")
        bh, bw = c["bh_pad"], c["bw_pad"]
        blocks = idct_islow(np.asarray(flat, np.int64).reshape(-1, 8, 8), f.qt[c["tq"]])
        plane = blocks.reshape(bh, bw, 8, 8).transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        dh = math.ceil(h_img * c["v"] / vmax)
        dw = math.ceil(w_img * c["h"] / hmax)
        up = _upsample(plane[:dh, :dw], hmax // c["h"], vmax // c["v"])
        planes.append(up[:h_img, :w_img])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=-1)
    if _is_rgb(f):
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*planes)


def read(path: str) -> np.ndarray:
    """A JPEG file → uint8 [H, W, 3] RGB."""
    with open(path, "rb") as fh:
        data = fh.read()
    return decode(data, str(path))


def exif_orientation(data: bytes) -> int:
    """The EXIF orientation tag (0x0112, 1-8) of the first APP1 "Exif"
    segment before the first scan, 1 when there is none or it is out of
    range (as libjpeg-based readers take it)."""
    pos = 2
    while pos < len(data):
        try:
            marker, body, pos = _next_segment(data, pos, "<exif>")
        except (ValueError, struct.error):
            return 1
        if marker in (0xDA, 0xD9):
            return 1
        if marker != 0xE1 or body[:6] != b"Exif\0\0":
            continue
        tiff = body[6:]
        order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
        if order is None or len(tiff) < 8:
            return 1
        ifd = struct.unpack(order + "I", tiff[4:8])[0]
        if ifd + 2 > len(tiff):
            return 1
        n = struct.unpack(order + "H", tiff[ifd:ifd + 2])[0]
        for i in range(n):
            e = ifd + 2 + 12 * i
            if e + 12 > len(tiff):
                return 1
            tag, kind = struct.unpack(order + "HH", tiff[e:e + 4])
            if tag == 0x0112 and kind == 3:                 # SHORT
                value = struct.unpack(order + "H", tiff[e + 8:e + 10])[0]
                return value if 1 <= value <= 8 else 1
        return 1
    return 1


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """[H, W, C] as displayed under an EXIF ``orientation``: OpenCV's
    ``ExifTransform`` (a transpose for 5-8, then a flip)."""
    if orientation >= 5:
        img = img.transpose(1, 0, 2)
    flip = {2: (slice(None), slice(None, None, -1)),
            3: (slice(None, None, -1), slice(None, None, -1)),
            4: (slice(None, None, -1),),
            6: (slice(None), slice(None, None, -1)),
            7: (slice(None, None, -1), slice(None, None, -1)),
            8: (slice(None, None, -1),)}.get(orientation)
    return np.ascontiguousarray(img[flip] if flip else img)


def read_oriented(path: str) -> np.ndarray:
    """:func:`read` with the file's EXIF orientation applied, as
    ``cv2.imread`` reads it."""
    with open(path, "rb") as fh:
        data = fh.read()
    return orient(decode(data, str(path)), exif_orientation(data))


def dims(path: str):
    """(H, W) from the frame header."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file")
    f, pos = _Frame(), 2
    while f.size is None:
        marker, body, pos = _next_segment(data, pos, str(path))
        if marker in (0xDA, 0xD9):
            break
        _read_tables(f, marker, body, str(path))
    if f.size is not None:
        return f.size
    raise ValueError(f"{path}: JPEG without a frame header")


def is_jpeg_path(path) -> bool:
    return os.path.splitext(str(path))[1].lower() in (".jpg", ".jpeg")


# --------------------------------------------------------------- encoder
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.full(64, 99)
_STD_CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]


def _ac_values(prefix):
    """Annex K.3's AC symbol order: the listed prefix, then every other
    (run, size) symbol in increasing order."""
    every = [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)]
    rest = sorted(set(every) - set(prefix))
    return list(prefix) + rest


_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], _ac_values([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A]))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], _ac_values([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A]))


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's ``jpeg_quality_scaling`` and ``jpeg_add_quant_table`` with
    ``force_baseline``: entries in [1, 255]."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.int64)


def _codes(bits, vals):
    """symbol → (code, length) of a canonical Huffman table."""
    table, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            table[vals[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return table


def _dct_matrix():
    d = np.zeros((8, 8))
    for u in range(8):
        cu = math.sqrt(0.125) if u == 0 else 0.5
        for x in range(8):
            d[u, x] = cu * math.cos((2 * x + 1) * u * math.pi / 16)
    return d


_DCT = _dct_matrix()


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) → [H/8, W/8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _bitcount(v: int) -> int:
    return abs(v).bit_length()


def write_jpeg(path: str, rgb: np.ndarray, quality: int = 95) -> str:
    """uint8 [H, W, 3] RGB → a baseline 4:2:0 JPEG at ``path``."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"{path}: write_jpeg takes uint8 [H, W, 3], "
                         f"got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    ph, pw = -(-h // 16) * 16, -(-w // 16) * 16
    img = np.pad(rgb, ((0, ph - h), (0, pw - w), (0, 0)), mode="edge").astype(np.float64)
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0
    planes = [np.clip(np.floor(p + 0.5), 0, 255).astype(np.int64) for p in (y, cb, cr)]
    # h2v2 downsampling with libjpeg's alternating 1, 2 bias
    bias = np.tile([1, 2], pw // 4)[None, :]
    for i in (1, 2):
        p = planes[i]
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        planes[i] = (s + bias) >> 2
    qts = [quality_table(_STD_LUMA_Q, quality), quality_table(_STD_CHROMA_Q, quality)]
    quant = []
    for i, p in enumerate(planes):
        blk = _blocks(p.astype(np.float64) - 128.0)
        coef = np.einsum("ux,abxy,vy->abuv", _DCT, blk, _DCT).reshape(*blk.shape[:2], 64)
        q = qts[min(i, 1)]
        # baseline AC codes carry at most 10 bits
        qc = np.clip(np.round(coef / q[None, None, :]), -1023, 1023).astype(np.int64)
        quant.append(qc[..., ZIGZAG])
    dc_tabs = [_codes(*_DC_LUMA), _codes(*_DC_CHROMA)]
    ac_tabs = [_codes(*_AC_LUMA), _codes(*_AC_CHROMA)]
    codes, lengths = [], []
    pred = [0, 0, 0]
    my, mx = ph // 16, pw // 16
    for yy in range(my):
        for xx in range(mx):
            units = [(0, 2 * yy + dy, 2 * xx + dx) for dy in range(2) for dx in range(2)]
            units += [(1, yy, xx), (2, yy, xx)]
            for ci, by, bx in units:
                blk = quant[ci][by, bx]
                t = min(ci, 1)
                diff = int(blk[0]) - pred[ci]
                pred[ci] = int(blk[0])
                s = _bitcount(diff)
                c, n = dc_tabs[t][s]
                codes.append(c)
                lengths.append(n)
                if s:
                    codes.append(diff if diff > 0 else diff + (1 << s) - 1)
                    lengths.append(s)
                nz = np.flatnonzero(blk[1:]) + 1
                last = 0
                for j in nz.tolist():
                    run = j - last - 1
                    while run > 15:
                        c, n = ac_tabs[t][0xF0]
                        codes.append(c)
                        lengths.append(n)
                        run -= 16
                    v = int(blk[j])
                    s = _bitcount(v)
                    c, n = ac_tabs[t][(run << 4) | s]
                    codes.append(c)
                    lengths.append(n)
                    codes.append(v if v > 0 else v + (1 << s) - 1)
                    lengths.append(s)
                    last = j
                if last < 63:
                    c, n = ac_tabs[t][0x00]
                    codes.append(c)
                    lengths.append(n)
    data = _pack_bits(np.asarray(codes, np.int64), np.asarray(lengths, np.int64))

    def seg(marker, body):
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = [b"\xff\xd8", seg(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, q in enumerate(qts):
        out.append(seg(0xDB, bytes([i]) + bytes(q[ZIGZAG].astype(np.uint8).tolist())))
    out.append(seg(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                   + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for tc, th, (bits, vals) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA),
                                 (0, 1, _DC_CHROMA), (1, 1, _AC_CHROMA)):
        out.append(seg(0xC4, bytes([(tc << 4) | th]) + bytes(bits) + bytes(vals)))
    out.append(seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out += [data, b"\xff\xd9"]
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return path


def _pack_bits(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Concatenate (code, length) bit strings MSB first, pad the last byte
    with 1s and stuff a 0x00 after every 0xFF."""
    keep = lengths > 0
    codes, lengths = codes[keep], lengths[keep]
    total = int(lengths.sum())
    owner = np.repeat(np.arange(len(codes)), lengths)
    start = np.repeat(np.cumsum(lengths) - lengths, lengths)
    shift = lengths[owner] - 1 - (np.arange(total) - start)
    bits = ((codes[owner] >> shift) & 1).astype(np.uint8)
    pad = (-total) % 8
    bits = np.concatenate([bits, np.ones(pad, np.uint8)])
    packed = np.packbits(bits)
    ff = np.flatnonzero(packed == 0xFF)
    return np.insert(packed, ff + 1, 0).tobytes()
