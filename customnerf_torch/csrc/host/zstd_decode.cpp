// A Zstandard frame decoder (RFC 8878) with a C interface, and the CRC-32C
// that guards OCDBT manifests and B+tree nodes.
//
// Covered: skippable frames; several frames in one buffer; raw, RLE and
// compressed blocks; literals raw, RLE and Huffman-coded (1 or 4 streams,
// the tree given as direct 4-bit weights or FSE-compressed weights, or
// repeated from the previous block: "treeless"); sequences in predefined,
// RLE, FSE-compressed and repeat modes, with the three repeat offsets; the
// window; the optional XXH64 content checksum, verified.  Dictionaries are
// not: a frame that names one raises.
//
// The output buffer is the history: a match copies from bytes this frame
// wrote earlier in the same buffer, never from before the frame's start.
// Every read of the input and every write of the output is bounds-checked;
// a corrupt or truncated frame raises std::runtime_error, which the C entry
// points turn into an error message and a nonzero status.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

[[noreturn]] void fail(const std::string& what) {
  throw std::runtime_error(what);
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint64_t load_le64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

inline uint32_t load_le32(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 |
         uint32_t(p[3]) << 24;
}

// ------------------------------------------------------------------ XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;

inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xxround(uint64_t acc, uint64_t in) {
  return rotl(acc + in * P2, 31) * P1;
}
inline uint64_t xxmerge(uint64_t acc, uint64_t v) {
  acc ^= xxround(0, v);
  return acc * P1 + P4;
}

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    const uint8_t* limit = end - 32;
    do {
      v1 = xxround(v1, load_le64(p));
      v2 = xxround(v2, load_le64(p + 8));
      v3 = xxround(v3, load_le64(p + 16));
      v4 = xxround(v4, load_le64(p + 24));
      p += 32;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xxmerge(h, v1);
    h = xxmerge(h, v2);
    h = xxmerge(h, v3);
    h = xxmerge(h, v4);
  } else {
    h = P5;
  }
  h += n;
  while (p + 8 <= end) {
    h ^= xxround(0, load_le64(p));
    h = rotl(h, 27) * P1 + P4;
    p += 8;
  }
  if (p + 4 <= end) {
    h ^= uint64_t(load_le32(p)) * P1;
    h = rotl(h, 23) * P2 + P3;
    p += 4;
  }
  while (p < end) {
    h ^= uint64_t(*p++) * P5;
    h = rotl(h, 11) * P1;
  }
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ------------------------------------------------------- backward bits
// A backward bitstream (FSE and Huffman streams): read from its last bit
// toward its first, the highest set bit of the last byte a marker.  The
// stream is copied behind 8 zero bytes, so a read that runs up to 64 bits
// past the beginning sees zeros (the FSE tail's "overconsumed" reads).
struct BackBits {
  std::vector<uint8_t> buf;
  int64_t pos = 0;  // bits left: the next read ends at bit pos

  BackBits(const uint8_t* src, size_t n) {
    if (n == 0) fail("zstd: empty bitstream");
    if (src[n - 1] == 0) fail("zstd: bitstream without its end marker");
    buf.assign(n + 16, 0);
    std::memcpy(buf.data() + 8, src, n);
    pos = int64_t(n - 1) * 8 + highbit(src[n - 1]);
  }
  // the nb (< 57) bits below bit position p, as an unsigned value
  inline uint64_t peek_at(int64_t p, int nb) const {
    if (p < -64) fail("zstd: bitstream overread");
    int64_t byte = p >> 3;  // floor, p may be negative
    uint64_t w = load_le64(buf.data() + 8 + byte);
    return (w >> (p & 7)) & ((nb == 64) ? ~0ULL : ((1ULL << nb) - 1));
  }
  inline uint64_t read(int nb) {
    if (nb == 0) return 0;
    pos -= nb;
    return peek_at(pos, nb);
  }
  inline uint64_t peek(int nb) const { return peek_at(pos - nb, nb); }
  inline void skip(int nb) { pos -= nb; }
};

// ------------------------------------------------------------------ FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t nbits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
};

// FSE_readNCount: the normalized counts of a table description (forward,
// LSB-first bits).  Returns the bytes it took.
size_t read_ncount(const uint8_t* src, size_t n, int max_symbol, int max_log,
                   std::vector<int>& norm, int& table_log) {
  if (n < 1) fail("zstd: truncated FSE table description");
  int64_t bit = 0;
  int64_t nbits_total = int64_t(n) * 8;
  auto get = [&](int nb) -> uint32_t {
    // nb <= 24
    uint64_t v = 0;
    int64_t byte = bit >> 3;
    for (int i = 0; i < 5; i++)
      if (byte + i < int64_t(n)) v |= uint64_t(src[byte + i]) << (8 * i);
    return uint32_t((v >> (bit & 7)) & ((1ULL << nb) - 1));
  };
  table_log = int(get(4)) + 5;
  bit += 4;
  if (table_log > max_log) fail("zstd: FSE table log too large");
  norm.assign(max_symbol + 1, 0);
  int remaining = (1 << table_log) + 1;
  int threshold = 1 << table_log;
  int nbits = table_log + 1;
  int charnum = 0;
  bool previous0 = false;
  while (remaining > 1 && charnum <= max_symbol) {
    if (previous0) {
      int n0 = charnum;
      while (get(2) == 3) {
        n0 += 3;
        bit += 2;
        if (bit > nbits_total) fail("zstd: truncated FSE table description");
      }
      n0 += int(get(2));
      bit += 2;
      if (n0 > max_symbol + 1) fail("zstd: FSE table description overruns its symbols");
      while (charnum < n0) norm[charnum++] = 0;
      if (charnum > max_symbol) break;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    uint32_t v = get(nbits);
    if (int(v & (threshold - 1)) < max) {
      count = int(v & (threshold - 1));
      bit += nbits - 1;
    } else {
      count = int(v & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      bit += nbits;
    }
    count--;
    remaining -= count < 0 ? -count : count;
    norm[charnum++] = count;
    previous0 = (count == 0);
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
    if (bit > nbits_total) fail("zstd: truncated FSE table description");
  }
  if (remaining != 1) fail("zstd: corrupt FSE table description");
  if (bit > nbits_total) fail("zstd: truncated FSE table description");
  norm.resize(charnum);
  return size_t((bit + 7) >> 3);
}

void build_fse(const std::vector<int>& norm, int table_log, FseTable& out) {
  int size = 1 << table_log;
  out.log = table_log;
  out.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); s++) {
    if (norm[s] == -1) {
      if (high < 0) fail("zstd: corrupt FSE distribution");
      out.t[high--].symbol = uint16_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  int step = (size >> 1) + (size >> 3) + 3;
  int mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); s++) {
    for (int i = 0; i < norm[s]; i++) {
      out.t[pos].symbol = uint16_t(s);
      do {
        pos = (pos + step) & mask;
      } while (pos > high);
    }
  }
  if (pos != 0) fail("zstd: corrupt FSE distribution");
  for (int u = 0; u < size; u++) {
    uint16_t s = out.t[u].symbol;
    uint32_t ns = next[s]++;
    if (ns == 0) fail("zstd: corrupt FSE distribution");
    int nb = table_log - highbit(ns);
    out.t[u].nbits = uint8_t(nb);
    out.t[u].base = uint16_t((ns << nb) - size);
  }
}

void rle_fse(int symbol, FseTable& out) {
  out.log = 0;
  out.t.assign(1, FseEntry{uint16_t(symbol), 0, 0});
}

// -------------------------------------------------------------- Huffman
struct HufTable {
  int max_bits = 0;
  std::vector<uint8_t> sym, nb;  // [1 << max_bits]
  bool valid = false;
};

// The Huffman tree description at src: the table; returns the bytes it took.
size_t read_huffman(const uint8_t* src, size_t n, HufTable& huf) {
  if (n < 1) fail("zstd: truncated Huffman tree description");
  int header = src[0];
  std::vector<uint8_t> w;
  size_t used;
  if (header >= 128) {
    int count = header - 127;
    size_t bytes = size_t(count + 1) / 2;
    if (1 + bytes > n) fail("zstd: truncated Huffman weights");
    for (int i = 0; i < count; i++) {
      uint8_t b = src[1 + i / 2];
      w.push_back((i % 2 == 0) ? (b >> 4) : (b & 15));
    }
    used = 1 + bytes;
  } else {
    size_t csize = size_t(header);
    if (csize == 0 || 1 + csize > n) fail("zstd: truncated Huffman weights");
    const uint8_t* p = src + 1;
    std::vector<int> norm;
    int log;
    size_t hs = read_ncount(p, csize, 255, 6, norm, log);
    if (hs >= csize) fail("zstd: corrupt Huffman weights");
    FseTable t;
    build_fse(norm, log, t);
    BackBits bits(p + hs, csize - hs);
    uint32_t s1 = uint32_t(bits.read(log)), s2 = uint32_t(bits.read(log));
    while (true) {
      if (w.size() >= 255) fail("zstd: too many Huffman weights");
      w.push_back(uint8_t(t.t[s1].symbol));
      s1 = t.t[s1].base + uint32_t(bits.read(t.t[s1].nbits));
      if (bits.pos < 0) {
        w.push_back(uint8_t(t.t[s2].symbol));
        break;
      }
      if (w.size() >= 255) fail("zstd: too many Huffman weights");
      w.push_back(uint8_t(t.t[s2].symbol));
      s2 = t.t[s2].base + uint32_t(bits.read(t.t[s2].nbits));
      if (bits.pos < 0) {
        w.push_back(uint8_t(t.t[s1].symbol));
        break;
      }
    }
    used = 1 + csize;
  }
  if (w.size() > 255) fail("zstd: too many Huffman weights");
  uint32_t sum = 0;
  for (uint8_t x : w) {
    if (x > 11) fail("zstd: Huffman weight too large");
    if (x) sum += 1u << (x - 1);
  }
  if (sum == 0) fail("zstd: Huffman weights all zero");
  int max_bits = highbit(sum) + 1;
  uint32_t left = (1u << max_bits) - sum;
  if (left & (left - 1)) fail("zstd: Huffman weights do not complete a tree");
  w.push_back(uint8_t(highbit(left) + 1));
  if (max_bits > 11) fail("zstd: Huffman code too long");
  huf.max_bits = max_bits;
  huf.sym.assign(size_t(1) << max_bits, 0);
  huf.nb.assign(size_t(1) << max_bits, 0);
  size_t pos = 0;
  for (int weight = 1; weight <= max_bits; weight++) {
    for (size_t s = 0; s < w.size(); s++) {
      if (w[s] != weight) continue;
      size_t len = size_t(1) << (weight - 1);
      if (pos + len > huf.sym.size()) fail("zstd: corrupt Huffman weights");
      std::memset(huf.sym.data() + pos, int(s), len);
      std::memset(huf.nb.data() + pos, max_bits + 1 - weight, len);
      pos += len;
    }
  }
  if (pos != huf.sym.size()) fail("zstd: corrupt Huffman weights");
  huf.valid = true;
  return used;
}

// Decode n (1 or 4) Huffman streams.  The fast loop refills a 57-bit window
// per stream and takes 5 symbols from it (a code has at most 11 bits), the
// streams interleaved; the tails go symbol by symbol.  Each stream must end
// exactly at its first bit.
void huffman_streams(const HufTable& huf, const uint8_t* const* src,
                     const size_t* len, uint8_t* const* out, const size_t* count,
                     int n) {
  const int mb = huf.max_bits;
  std::vector<uint16_t> entry(huf.sym.size());
  for (size_t i = 0; i < entry.size(); i++)
    entry[i] = uint16_t(huf.sym[i] | (huf.nb[i] << 8));
  const uint16_t* e = entry.data();
  const uint32_t mask = (1u << mb) - 1;
  BackBits* bits[4];
  std::vector<BackBits> owned;
  owned.reserve(n);
  for (int s = 0; s < n; s++) owned.emplace_back(src[s], len[s]);
  size_t done[4] = {0, 0, 0, 0};
  for (int s = 0; s < n; s++) bits[s] = &owned[s];
  while (true) {
    bool fast = true;
    for (int s = 0; s < n; s++)
      fast = fast && bits[s]->pos >= 57 && count[s] - done[s] >= 5;
    if (!fast) break;
    for (int s = 0; s < n; s++) {
      BackBits& b = *bits[s];
      int64_t base = b.pos - 57;
      uint64_t w = load_le64(b.buf.data() + 8 + (base >> 3)) >> (base & 7);
      int used = 0;
      uint8_t* o = out[s] + done[s];
      for (int k = 0; k < 5; k++) {
        uint16_t x = e[(w >> (57 - used - mb)) & mask];
        o[k] = uint8_t(x);
        used += x >> 8;
      }
      b.pos -= used;
      done[s] += 5;
    }
  }
  for (int s = 0; s < n; s++) {
    BackBits& b = *bits[s];
    for (size_t i = done[s]; i < count[s]; i++) {
      uint16_t x = e[uint32_t(b.peek(mb))];
      out[s][i] = uint8_t(x);
      b.skip(x >> 8);
      if (b.pos < 0) fail("zstd: Huffman stream overread");
    }
    if (b.pos != 0) fail("zstd: Huffman stream not fully consumed");
  }
}

// ------------------------------------------------------------- sequences
constexpr int LL_MAX = 35, ML_MAX = 52, OF_MAX = 31;
const int LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                            2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                            -1, -1, -1, -1};
const int ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                            -1, -1, -1, -1, -1};
const int OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,
                              10, 11, 12,  13,  14,  15,   16,   18,   20,   22,
                              24, 28, 32,  40,  48,  64,   128,  256,  512,  1024,
                              2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771,
                              65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint64_t rep[3] = {1, 4, 8};
};

// One of the three tables of a sequences section, in the mode its 2 bits
// name; returns the bytes its description took.
size_t read_seq_table(int mode, const uint8_t* src, size_t n, FseTable& t, bool& have,
                      const int* def, int ndef, int def_log, int max_symbol,
                      int max_log) {
  switch (mode) {
    case 0: {
      std::vector<int> norm(def, def + ndef);
      build_fse(norm, def_log, t);
      have = true;
      return 0;
    }
    case 1: {
      if (n < 1) fail("zstd: truncated sequences section");
      if (src[0] > max_symbol) fail("zstd: RLE sequence symbol out of range");
      rle_fse(src[0], t);
      have = true;
      return 1;
    }
    case 2: {
      std::vector<int> norm;
      int log;
      size_t used = read_ncount(src, n, max_symbol, max_log, norm, log);
      build_fse(norm, log, t);
      have = true;
      return used;
    }
    default:
      if (!have) fail("zstd: repeat-mode sequence table without a previous table");
      return 0;
  }
}

struct Out {
  uint8_t* data;
  size_t cap;
  size_t size;      // bytes written in the whole buffer
  size_t frame0;    // where the current frame began
  bool too_small = false;
  void need(size_t n) {
    if (size + n > cap) {
      too_small = true;
      fail("zstd: output buffer too small");
    }
  }
};

void decode_block(const uint8_t* src, size_t n, FrameState& fs, Out& out,
                  size_t block_max) {
  // ---- literals section
  if (n < 1) fail("zstd: truncated literals section");
  int ltype = src[0] & 3;
  int sf = (src[0] >> 2) & 3;
  size_t regen = 0, csize = 0, hsize = 0;
  int streams = 1;
  if (ltype < 2) {
    if (sf == 0 || sf == 2) {
      regen = src[0] >> 3;
      hsize = 1;
    } else if (sf == 1) {
      if (n < 2) fail("zstd: truncated literals header");
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
      hsize = 2;
    } else {
      if (n < 3) fail("zstd: truncated literals header");
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
      hsize = 3;
    }
  } else {
    int bits;
    if (sf == 0 || sf == 1) {
      hsize = 3;
      bits = 10;
      streams = sf == 0 ? 1 : 4;
    } else if (sf == 2) {
      hsize = 4;
      bits = 14;
      streams = 4;
    } else {
      hsize = 5;
      bits = 18;
      streams = 4;
    }
    if (n < hsize) fail("zstd: truncated literals header");
    uint64_t h = 0;
    for (size_t i = 0; i < hsize; i++) h |= uint64_t(src[i]) << (8 * i);
    regen = size_t((h >> 4) & ((1ULL << bits) - 1));
    csize = size_t((h >> (4 + bits)) & ((1ULL << bits) - 1));
  }
  if (regen > block_max) fail("zstd: literals larger than a block");
  std::vector<uint8_t> lit(regen + 8);
  size_t p = hsize;
  if (ltype == 0) {
    if (p + regen > n) fail("zstd: truncated raw literals");
    std::memcpy(lit.data(), src + p, regen);
    p += regen;
  } else if (ltype == 1) {
    if (p + 1 > n) fail("zstd: truncated RLE literals");
    std::memset(lit.data(), src[p], regen);
    p += 1;
  } else {
    if (p + csize > n) fail("zstd: truncated compressed literals");
    const uint8_t* c = src + p;
    size_t cn = csize;
    if (ltype == 2) {
      size_t used = read_huffman(c, cn, fs.huf);
      c += used;
      cn -= used;
    } else if (!fs.huf.valid) {
      fail("zstd: treeless literals without a previous Huffman table");
    }
    if (streams == 1) {
      const uint8_t* srcs[1] = {c};
      uint8_t* outs[1] = {lit.data()};
      huffman_streams(fs.huf, srcs, &cn, outs, &regen, 1);
    } else {
      if (cn < 10) fail("zstd: truncated 4-stream literals");
      size_t s1 = c[0] | size_t(c[1]) << 8, s2 = c[2] | size_t(c[3]) << 8,
             s3 = c[4] | size_t(c[5]) << 8;
      if (6 + s1 + s2 + s3 > cn) fail("zstd: corrupt literals jump table");
      size_t s4 = cn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      if (3 * seg > regen) fail("zstd: corrupt 4-stream literals sizes");
      const uint8_t* q = c + 6;
      const uint8_t* srcs[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
      size_t lens[4] = {s1, s2, s3, s4};
      uint8_t* outs[4] = {lit.data(), lit.data() + seg, lit.data() + 2 * seg,
                          lit.data() + 3 * seg};
      size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      huffman_streams(fs.huf, srcs, lens, outs, counts, 4);
    }
    p += csize;
  }

  // ---- sequences section
  if (p >= n) fail("zstd: truncated sequences section");
  size_t nseq;
  int b0 = src[p];
  if (b0 == 0) {
    nseq = 0;
    p += 1;
  } else if (b0 < 128) {
    nseq = size_t(b0);
    p += 1;
  } else if (b0 < 255) {
    if (p + 2 > n) fail("zstd: truncated sequences header");
    nseq = (size_t(b0 - 128) << 8) + src[p + 1];
    p += 2;
  } else {
    if (p + 3 > n) fail("zstd: truncated sequences header");
    nseq = size_t(src[p + 1]) + (size_t(src[p + 2]) << 8) + 0x7F00;
    p += 3;
  }
  size_t lit_pos = 0;
  if (nseq == 0) {
    if (p != n) fail("zstd: bytes after an empty sequences section");
  } else {
    if (p >= n) fail("zstd: truncated sequences header");
    int modes = src[p++];
    if (modes & 3) fail("zstd: reserved bits set in the sequences modes");
    p += read_seq_table((modes >> 6) & 3, src + p, n - p, fs.ll, fs.have_ll,
                        LL_DEFAULT, 36, 6, LL_MAX, 9);
    p += read_seq_table((modes >> 4) & 3, src + p, n - p, fs.of, fs.have_of,
                        OF_DEFAULT, 29, 5, OF_MAX, 8);
    p += read_seq_table((modes >> 2) & 3, src + p, n - p, fs.ml, fs.have_ml,
                        ML_DEFAULT, 53, 6, ML_MAX, 9);
    if (p >= n) fail("zstd: truncated sequences bitstream");
    BackBits bits(src + p, n - p);
    uint32_t sll = uint32_t(bits.read(fs.ll.log));
    uint32_t sof = uint32_t(bits.read(fs.of.log));
    uint32_t sml = uint32_t(bits.read(fs.ml.log));
    for (size_t i = 0; i < nseq; i++) {
      const FseEntry& el = fs.ll.t[sll];
      const FseEntry& eo = fs.of.t[sof];
      const FseEntry& em = fs.ml.t[sml];
      int llc = el.symbol, ofc = eo.symbol, mlc = em.symbol;
      if (llc > LL_MAX || mlc > ML_MAX || ofc > OF_MAX)
        fail("zstd: sequence code out of range");
      uint64_t ofv = (1ULL << ofc) + bits.read(ofc);
      uint64_t ml = ML_BASE[mlc] + bits.read(ML_BITS[mlc]);
      uint64_t ll = LL_BASE[llc] + bits.read(LL_BITS[llc]);
      if (bits.pos < 0) fail("zstd: sequences bitstream overread");
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        fs.rep[2] = fs.rep[1];
        fs.rep[1] = fs.rep[0];
        fs.rep[0] = offset;
      } else {
        uint64_t idx = ofv + (ll == 0 ? 1 : 0);
        if (idx == 1) {
          offset = fs.rep[0];
        } else if (idx == 2) {
          offset = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = offset;
        } else {
          offset = idx == 3 ? fs.rep[2] : fs.rep[0] - 1;
          if (offset == 0) fail("zstd: zero repeat offset");
          fs.rep[2] = fs.rep[1];
          fs.rep[1] = fs.rep[0];
          fs.rep[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll = el.base + uint32_t(bits.read(el.nbits));
        sml = em.base + uint32_t(bits.read(em.nbits));
        sof = eo.base + uint32_t(bits.read(eo.nbits));
        if (bits.pos < 0) fail("zstd: sequences bitstream overread");
      }
      // execute: ll literals, then ml bytes from offset back
      if (ll > regen - lit_pos) fail("zstd: sequence takes more literals than there are");
      out.need(size_t(ll) + size_t(ml));
      std::memcpy(out.data + out.size, lit.data() + lit_pos, size_t(ll));
      out.size += size_t(ll);
      lit_pos += size_t(ll);
      if (offset > out.size - out.frame0) fail("zstd: match offset before the frame's start");
      uint8_t* d = out.data + out.size;
      const uint8_t* s = d - offset;
      if (offset >= ml) {
        std::memcpy(d, s, size_t(ml));
      } else {
        for (uint64_t k = 0; k < ml; k++) d[k] = s[k];
      }
      out.size += size_t(ml);
    }
    if (bits.pos != 0) fail("zstd: sequences bitstream not fully consumed");
  }
  size_t rest = regen - lit_pos;
  out.need(rest);
  std::memcpy(out.data + out.size, lit.data() + lit_pos, rest);
  out.size += rest;
}

struct FrameHeader {
  size_t header_size;
  int64_t content_size;  // -1: not given
  uint64_t window;
  bool checksum;
};

FrameHeader parse_header(const uint8_t* src, size_t n) {
  // src at the frame's first byte after the magic
  if (n < 1) fail("zstd: truncated frame header");
  int fhd = src[0];
  int fcs_flag = fhd >> 6;
  bool single = (fhd >> 5) & 1;
  if (fhd & 8) fail("zstd: reserved bit set in the frame header");
  int did_flag = fhd & 3;
  FrameHeader h;
  h.checksum = (fhd >> 2) & 1;
  size_t p = 1;
  uint64_t window = 0;
  if (!single) {
    if (p >= n) fail("zstd: truncated frame header");
    int wd = src[p++];
    int exponent = wd >> 3, mantissa = wd & 7;
    int wlog = 10 + exponent;
    if (wlog > 41) fail("zstd: window too large");
    uint64_t base = 1ULL << wlog;
    window = base + (base / 8) * uint64_t(mantissa);
  }
  static const int did_size[4] = {0, 1, 2, 4};
  uint64_t did = 0;
  if (p + did_size[did_flag] > n) fail("zstd: truncated frame header");
  for (int i = 0; i < did_size[did_flag]; i++) did |= uint64_t(src[p + i]) << (8 * i);
  p += did_size[did_flag];
  if (did != 0) fail("zstd: frame needs a dictionary, which is not supported");
  int fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (1 << fcs_flag);
  if (p + fcs_size > n) fail("zstd: truncated frame header");
  int64_t fcs = -1;
  if (fcs_size) {
    uint64_t v = 0;
    for (int i = 0; i < fcs_size; i++) v |= uint64_t(src[p + i]) << (8 * i);
    if (fcs_size == 2) v += 256;
    fcs = int64_t(v);
  }
  p += fcs_size;
  if (single) window = uint64_t(fcs);
  h.header_size = p;
  h.content_size = fcs;
  h.window = window;
  return h;
}

constexpr uint32_t MAGIC = 0xFD2FB528u;

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

// The sum of the frames' content sizes; -1 when a frame does not give it.
int64_t content_size(const uint8_t* src, size_t n) {
  size_t p = 0;
  int64_t total = 0;
  bool known = true;
  while (p < n) {
    if (n - p < 4) fail("zstd: truncated frame");
    uint32_t magic = load_le32(src + p);
    if (skippable(magic)) {
      if (n - p < 8) fail("zstd: truncated skippable frame");
      uint64_t sz = load_le32(src + p + 4);
      if (sz > n - p - 8) fail("zstd: truncated skippable frame");
      p += 8 + size_t(sz);
      continue;
    }
    if (magic != MAGIC) fail("zstd: not a zstd frame (bad magic)");
    p += 4;
    FrameHeader h = parse_header(src + p, n - p);
    p += h.header_size;
    if (h.content_size < 0) known = false;
    else total += h.content_size;
    while (true) {
      if (n - p < 3) fail("zstd: truncated block header");
      uint32_t bh = src[p] | uint32_t(src[p + 1]) << 8 | uint32_t(src[p + 2]) << 16;
      p += 3;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) fail("zstd: reserved block type");
      size_t csz = type == 1 ? 1 : size;
      if (csz > n - p) fail("zstd: truncated block");
      p += csz;
      if (bh & 1) break;
    }
    if (h.checksum) {
      if (n - p < 4) fail("zstd: truncated checksum");
      p += 4;
    }
  }
  return known ? total : -1;
}

void decompress(const uint8_t* src, size_t n, Out& out) {
  size_t p = 0;
  bool any = false;
  while (p < n) {
    if (n - p < 4) fail("zstd: truncated frame");
    uint32_t magic = load_le32(src + p);
    if (skippable(magic)) {
      if (n - p < 8) fail("zstd: truncated skippable frame");
      uint64_t sz = load_le32(src + p + 4);
      if (sz > n - p - 8) fail("zstd: truncated skippable frame");
      p += 8 + size_t(sz);
      any = true;
      continue;
    }
    if (magic != MAGIC) fail("zstd: not a zstd frame (bad magic)");
    p += 4;
    FrameHeader h = parse_header(src + p, n - p);
    p += h.header_size;
    size_t block_max = size_t(h.window < (128u << 10) ? h.window : (128u << 10));
    out.frame0 = out.size;
    FrameState fs;
    while (true) {
      if (n - p < 3) fail("zstd: truncated block header");
      uint32_t bh = src[p] | uint32_t(src[p + 1]) << 8 | uint32_t(src[p + 2]) << 16;
      p += 3;
      bool last = bh & 1;
      int type = (bh >> 1) & 3;
      size_t size = bh >> 3;
      if (type == 3) fail("zstd: reserved block type");
      if (size > block_max && type != 1) fail("zstd: block larger than the maximum");
      if (type == 0) {
        if (size > n - p) fail("zstd: truncated raw block");
        out.need(size);
        std::memcpy(out.data + out.size, src + p, size);
        out.size += size;
        p += size;
      } else if (type == 1) {
        if (n - p < 1) fail("zstd: truncated RLE block");
        if (size > block_max) fail("zstd: block larger than the maximum");
        out.need(size);
        std::memset(out.data + out.size, src[p], size);
        out.size += size;
        p += 1;
      } else {
        if (size > n - p) fail("zstd: truncated compressed block");
        size_t before = out.size;
        decode_block(src + p, size, fs, out, block_max);
        if (out.size - before > block_max) fail("zstd: block decodes larger than the maximum");
        p += size;
      }
      if (last) break;
    }
    size_t produced = out.size - out.frame0;
    if (h.content_size >= 0 && uint64_t(h.content_size) != produced)
      fail("zstd: frame content size disagrees with its data");
    if (h.checksum) {
      if (n - p < 4) fail("zstd: truncated checksum");
      uint32_t want = load_le32(src + p);
      uint32_t got = uint32_t(xxh64(out.data + out.frame0, produced));
      if (want != got) fail("zstd: content checksum mismatch");
      p += 4;
    }
    any = true;
  }
  if (!any) fail("zstd: no frame");
}

void set_error(char* err, int errlen, const char* msg) {
  if (err && errlen > 0) {
    std::strncpy(err, msg, size_t(errlen) - 1);
    err[errlen - 1] = 0;
  }
}

// ---------------------------------------------------------------- CRC-32C
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
      for (int s = 1; s < 8; s++) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 255];
  }
};

}  // namespace

extern "C" {

// Sum of the content sizes its frame headers give: >= 0; -1 when a frame
// does not give its size; -2 when the buffer is not a well-formed frame
// sequence.
int64_t cn_zstd_content_size(const uint8_t* src, int64_t n) {
  try {
    return content_size(src, size_t(n));
  } catch (const std::exception&) {
    return -2;
  }
}

// Decompress every frame of src[0:n] into dst[0:cap].  Returns 0 and sets
// *written; 1 when dst is too small; 2 on a corrupt or truncated input,
// with the reason in err.
int cn_zstd_decompress(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                       int64_t* written, char* err, int errlen) {
  Out out{dst, size_t(cap), 0, 0};
  try {
    decompress(src, size_t(n), out);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    *written = int64_t(out.size);
    return out.too_small ? 1 : 2;
  }
  *written = int64_t(out.size);
  return 0;
}

// CRC-32C (Castagnoli) of p[0:n], continuing from crc (0 to start).
uint32_t cn_crc32c(const uint8_t* p, int64_t n, uint32_t crc) {
  static const Crc32cTable tab;
  uint32_t c = ~crc;
  while (n >= 8) {
    uint32_t lo = c ^ load_le32(p), hi = load_le32(p + 4);
    c = tab.t[7][lo & 255] ^ tab.t[6][(lo >> 8) & 255] ^ tab.t[5][(lo >> 16) & 255] ^
        tab.t[4][lo >> 24] ^ tab.t[3][hi & 255] ^ tab.t[2][(hi >> 8) & 255] ^
        tab.t[1][(hi >> 16) & 255] ^ tab.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n-- > 0) c = tab.t[0][(c ^ *p++) & 255] ^ (c >> 8);
  return ~c;
}

}  // extern "C"
