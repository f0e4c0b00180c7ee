// The JPEG decoder's Huffman stage (``customnerf_torch/utils/jpeg.py``) in
// C++: one scan's entropy-coded data into the components' coefficients.
//
// Sequential scans (interleaved or one component a scan) and the four
// progressive scan kinds of libjpeg's ``jdphuff.c`` (DC first, DC
// refinement, AC first with end-of-band runs, AC refinement with correction
// bits), with the DC predictors and the end-of-band run reset at each
// restart.  The Python side has parsed the markers, built the Huffman
// lookup tables and unstuffed the data; this code follows the plain Python
// loops of jpeg.py (``_decode_scan``, ``_decode_progressive_scan``) step
// for step, so both give the same coefficients and fail on the same files:
//
//   * a symbol is looked up in a 16-bit table (entry = length << 8 |
//     symbol, 0 where no code starts), the bits read through a big-endian
//     32-bit window at the byte of the bit position;
//   * each restart segment is followed by 8 zero bytes, and a window that
//     starts 5 or more bytes past the segment's end is an error: the scan
//     ended early.
//
// Coefficients are int32, natural order, a component's padded block grid
// row by row (block (by, bx) at (by * bw_pad + bx) * 64).

#include <cstdint>

namespace {

const int NATURAL[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // libjpeg's guard entries (jpeg_natural_order)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum { OK = 0, BAD_CODE = 1, ENDS_EARLY = 2, BAD_SCAN = 3 };

// a scan holds at most 4 components (libjpeg's MAX_COMPS_IN_SCAN)
constexpr int MAX_SLOTS = 4;

struct Bits {
  const uint8_t* d;
  int64_t limit;  // a window may start at byte < limit (segment length + 5)
  int64_t p = 0;  // bit position
  int err = OK;

  inline uint32_t window() {
    int64_t i = p >> 3;
    if (i >= limit) {
      err = ENDS_EARLY;
      return 0;
    }
    const uint8_t* q = d + i;
    return uint32_t(q[0]) << 24 | uint32_t(q[1]) << 16 | uint32_t(q[2]) << 8 | q[3];
  }
  // the next Huffman symbol's table entry (0: no code)
  inline int32_t lookup(const int32_t* lut) {
    uint32_t w = window();
    if (err) return 0;
    int32_t e = lut[(w >> (16 - (p & 7))) & 0xFFFF];
    if (!e) err = BAD_CODE;
    return e;
  }
  // s (<= 16) raw bits
  inline int32_t get(int s) {
    uint32_t w = window();
    if (err) return 0;
    int32_t v = int32_t((w >> (32 - s - (p & 7))) & ((1u << s) - 1));
    p += s;
    return v;
  }
  inline int bit() {
    uint32_t w = window();
    if (err) return 0;
    int b = int((w >> (31 - (p & 7))) & 1);
    p += 1;
    return b;
  }
};

inline int32_t extend(int32_t v, int s) {
  return v < (1 << (s - 1)) ? v - ((1 << s) - 1) : v;
}

struct Scan {
  int slots;
  int32_t** coefs;
  const int32_t *bw_pad, *hs, *vs;
  int bw1, bh1, mx, my;
  const int32_t* const* dc;
  const int32_t* const* ac;
  int progressive, ss, se, ah, al;
};

// the blocks of MCU m: (slot, block row, block column), as jpeg.py's
// ``_mcu_layout``
template <class F>
inline void for_blocks(const Scan& sc, int64_t m, F&& f) {
  if (sc.slots == 1) {
    f(0, m / sc.bw1, m % sc.bw1);
    return;
  }
  int64_t r = m / sc.mx, q = m % sc.mx;
  for (int k = 0; k < sc.slots; k++)
    for (int by = 0; by < sc.vs[k]; by++)
      for (int bx = 0; bx < sc.hs[k]; bx++)
        if (!f(k, r * sc.vs[k] + by, q * sc.hs[k] + bx)) return;
}

// one sequential block; false on an error (in b.err)
inline bool sequential_block(Bits& b, const Scan& sc, int k, int32_t* out,
                             int32_t* pred) {
  int32_t e = b.lookup(sc.dc[k]);
  if (b.err) return false;
  b.p += e >> 8;
  int s = e & 0xFF;
  int32_t diff = 0;
  if (s) {
    if (s > 16) {
      b.err = BAD_CODE;
      return false;
    }
    diff = extend(b.get(s), s);
    if (b.err) return false;
  }
  pred[k] += diff;
  out[0] = pred[k];
  int j = 1;
  while (j < 64) {
    e = b.lookup(sc.ac[k]);
    if (b.err) return false;
    b.p += e >> 8;
    int rs = e & 0xFF;
    s = rs & 15;
    if (s) {
      j += rs >> 4;
      int32_t v = extend(b.get(s), s);
      if (b.err) return false;
      if (j < 64) out[NATURAL[j]] = v;
      j += 1;
    } else if (rs == 0xF0) {
      j += 16;
    } else {
      break;
    }
  }
  return true;
}

inline bool dc_first_block(Bits& b, const Scan& sc, int k, int32_t* out, int32_t* pred) {
  int32_t e = b.lookup(sc.dc[k]);
  if (b.err) return false;
  b.p += e >> 8;
  int s = e & 0xFF;
  int32_t diff = 0;
  if (s) {
    if (s > 16) {
      b.err = BAD_CODE;
      return false;
    }
    diff = extend(b.get(s), s);
    if (b.err) return false;
  }
  pred[k] += diff;
  out[0] = int32_t(uint32_t(pred[k]) << sc.al);
  return true;
}

inline bool ac_first_block(Bits& b, const Scan& sc, int32_t* out, int64_t& eobrun) {
  if (eobrun) {
    eobrun -= 1;
    return true;
  }
  int k = sc.ss;
  while (k <= sc.se) {
    int32_t e = b.lookup(sc.ac[0]);
    if (b.err) return false;
    b.p += e >> 8;
    int r = (e >> 4) & 15, s = e & 15;
    if (s) {
      k += r;
      int32_t v = extend(b.get(s), s);
      if (b.err) return false;
      out[NATURAL[k]] = int32_t(uint32_t(v) << sc.al);
    } else if (r == 15) {
      k += 15;
    } else {
      eobrun = int64_t(1) << r;
      if (r) {
        eobrun += b.get(r);
        if (b.err) return false;
      }
      eobrun -= 1;
      break;
    }
    k += 1;
  }
  return true;
}

inline bool ac_refine_block(Bits& b, const Scan& sc, int32_t* out, int64_t& eobrun) {
  const int32_t p1 = int32_t(1u << sc.al), m1 = -p1;
  int k = sc.ss;
  if (!eobrun) {
    while (k <= sc.se) {
      int32_t e = b.lookup(sc.ac[0]);
      if (b.err) return false;
      b.p += e >> 8;
      int r = (e >> 4) & 15, s = e & 15;
      int32_t sv = 0;
      if (s) {
        int bit = b.bit();
        if (b.err) return false;
        sv = bit ? p1 : m1;
      } else if (r != 15) {
        eobrun = int64_t(1) << r;
        if (r) {
          eobrun += b.get(r);
          if (b.err) return false;
        }
        break;
      }
      while (k <= sc.se) {
        int32_t* c = out + NATURAL[k];
        if (*c) {
          int bit = b.bit();
          if (b.err) return false;
          if (bit && !(*c & p1)) *c = *c >= 0 ? *c + p1 : *c + m1;
        } else if (r == 0) {
          break;
        } else {
          r -= 1;
        }
        k += 1;
      }
      if (sv) out[NATURAL[k]] = sv;
      k += 1;
    }
  }
  if (eobrun) {
    while (k <= sc.se) {
      int32_t* c = out + NATURAL[k];
      if (*c) {
        int bit = b.bit();
        if (b.err) return false;
        if (bit && !(*c & p1)) *c = *c >= 0 ? *c + p1 : *c + m1;
      }
      k += 1;
    }
    eobrun -= 1;
  }
  return true;
}

}  // namespace

extern "C" {

// Decode one scan.  data: the unstuffed restart segments, each followed by 8
// zero bytes; part_off[i]..part_off[i + 1] - 8 is segment i.  Returns 0, 1
// (a bad Huffman code), 2 (the scan's data ends early) or 3 (slots outside
// 1..4, which the caller's header checks already refuse).
int cn_jpeg_decode_scan(const uint8_t* data, const int64_t* part_off, int n_parts,
                        int slots, int32_t** coefs, const int32_t* bw_pad,
                        const int32_t* hs, const int32_t* vs, int bw1, int bh1,
                        int mx, int my, const int32_t* const* dc,
                        const int32_t* const* ac, int restart, int progressive,
                        int ss, int se, int ah, int al) {
  if (slots < 1 || slots > MAX_SLOTS) return BAD_SCAN;
  Scan sc{slots, coefs, bw_pad, hs, vs, bw1, bh1, mx, my, dc, ac,
          progressive, ss, se, ah, al};
  const int64_t n_mcu = slots == 1 ? int64_t(bw1) * bh1 : int64_t(mx) * my;
  const int64_t per_part = restart ? restart : n_mcu;
  int64_t m = 0;
  for (int part = 0; part < n_parts; part++) {
    if (m >= n_mcu) break;
    Bits b{data + part_off[part], part_off[part + 1] - 8 - part_off[part] + 5};
    int32_t pred[MAX_SLOTS] = {0, 0, 0, 0};
    int64_t eobrun = 0;
    int64_t count = per_part < n_mcu - m ? per_part : n_mcu - m;
    for (int64_t i = 0; i < count; i++, m++) {
      for_blocks(sc, m, [&](int k, int64_t by, int64_t bx) -> bool {
        int32_t* out = coefs[k] + (by * bw_pad[k] + bx) * 64;
        if (!progressive) return sequential_block(b, sc, k, out, pred);
        if (ss == 0 && ah == 0) return dc_first_block(b, sc, k, out, pred);
        if (ss == 0) {
          int bit = b.bit();
          if (b.err) return false;
          if (bit) out[0] |= int32_t(1u << al);
          return true;
        }
        if (ah == 0) return ac_first_block(b, sc, out, eobrun);
        return ac_refine_block(b, sc, out, eobrun);
      });
      if (b.err) return b.err;
    }
  }
  return OK;
}

}  // extern "C"
