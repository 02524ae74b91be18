// A Zstandard frame decoder (RFC 8878, decompression only) and the CRC32C
// that OCDBT appends to each of its files, for reading the JAX package's
// Orbax checkpoints without a third-party decoder.
//
// Host C++, no dependencies. Built at first use by utils/orbax.py with the
// host compiler (-O3 -fPIC -shared -std=c++17) and bound through ctypes:
//
//   int64_t irtpu_zstd_decompress(src, n, dst, cap)  bytes written, or < 0
//   int64_t irtpu_zstd_content_size(src, n)          sum of the frames'
//                                                    declared sizes, -1 when
//                                                    one frame declares none
//   const char* irtpu_zstd_error_name(code)
//   uint32_t irtpu_crc32c(p, n)
//
// What it decodes: every frame of the input in turn (skippable frames are
// skipped), raw, RLE and compressed blocks; literals raw, RLE and Huffman
// (one or four streams, with a tree or treeless); sequences with predefined,
// RLE, FSE-compressed and repeat tables and the three repeat offsets, the
// window spanning blocks; single-segment frames and the frame content size;
// the XXH64 content checksum whenever a frame carries one. Dictionaries are
// refused. Corrupt input is an error, never a short output: every bitstream
// must end exactly where its last symbol ends, every offset must point inside
// the frame's output and window, every declared size must match.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

enum Err : int64_t {
  kCorrupt = -1,
  kDstTooSmall = -2,
  kChecksum = -3,
  kDictionary = -4,
  kTruncated = -5,
  kBadMagic = -6,
  kUnknownSize = -7,
};

struct Error {
  int64_t code;
};

[[noreturn]] void fail(int64_t code) { throw Error{code}; }
inline void need(bool ok, int64_t code = kCorrupt) {
  if (!ok) fail(code);
}

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) { return rd16(p) | (rd16(p + 2) << 16); }
inline uint64_t rd64(const uint8_t* p) { return rd32(p) | (uint64_t(rd32(p + 4)) << 32); }

// ---------------------------------------------------------------- XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL,
                   P3 = 1609587929392839161ULL, P4 = 9650029242287828579ULL,
                   P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t v) { return rotl(acc + v * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n, uint64_t seed) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p));
      v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16));
      v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1);
    h = xmerge(h, v2);
    h = xmerge(h, v3);
    h = xmerge(h, v4);
  } else {
    h = seed + P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) {
    h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------- CRC32C
struct Crc32cTable {
  uint32_t t[8][256];
  Crc32cTable() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0x82F63B78u & (0u - (c & 1)));
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i)
      for (int s = 1; s < 8; ++s) t[s][i] = (t[s - 1][i] >> 8) ^ t[0][t[s - 1][i] & 0xFF];
  }
};

uint32_t crc32c(const uint8_t* p, size_t n) {
  static const Crc32cTable T;
  uint32_t c = 0xFFFFFFFFu;
  for (; n >= 8; p += 8, n -= 8) {  // slicing by eight
    uint32_t lo = rd32(p) ^ c, hi = rd32(p + 4);
    c = T.t[7][lo & 0xFF] ^ T.t[6][(lo >> 8) & 0xFF] ^ T.t[5][(lo >> 16) & 0xFF] ^
        T.t[4][lo >> 24] ^ T.t[3][hi & 0xFF] ^ T.t[2][(hi >> 8) & 0xFF] ^
        T.t[1][(hi >> 16) & 0xFF] ^ T.t[0][hi >> 24];
  }
  for (; n; ++p, --n) c = (c >> 8) ^ T.t[0][(c ^ *p) & 0xFF];
  return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------- bitstreams
// Forward little-endian bits (FSE table descriptions). Bits past the end
// read as zero; the caller checks that what it consumed lies inside.
struct FwdBits {
  const uint8_t* p;
  size_t n;
  uint64_t pos = 0;
  uint32_t peek(int nb) const {
    uint64_t v = 0;
    size_t b = pos >> 3;
    for (int i = 0; i < 8 && b + i < n; ++i) v |= uint64_t(p[b + i]) << (8 * i);
    return uint32_t((v >> (pos & 7)) & ((1ull << nb) - 1));
  }
  uint32_t read(int nb) {
    uint32_t v = peek(nb);
    pos += nb;
    return v;
  }
};

// Backward bits (Huffman streams, FSE-coded sequences and weights): the
// stream is one little-endian integer whose highest set bit is a marker;
// reading takes bits from just below the marker towards bit 0. `pos` is the
// number of bits still unread.
struct BackBits {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int64_t pos = 0;
  void init(const uint8_t* s, size_t sz) {
    need(sz > 0 && s[sz - 1] != 0);
    p = s;
    n = sz;
    pos = int64_t(sz - 1) * 8 + highbit(s[sz - 1]);
  }
  // 64 bits from byte b on, zeros past the end
  uint64_t load(int64_t b) const {
    uint64_t v = 0;
    if (b + 8 <= int64_t(n)) {
      std::memcpy(&v, p + b, 8);  // little-endian host
    } else {
      for (int64_t i = 0; b + i < int64_t(n); ++i) v |= uint64_t(p[b + i]) << (8 * i);
    }
    return v;
  }
  // bits [lo, lo + nb), nb <= 56, with bits below 0 read as zero
  uint64_t bits(int64_t lo, int nb) const {
    if (nb == 0) return 0;
    if (lo >= 0) return (load(lo >> 3) >> (lo & 7)) & ((1ull << nb) - 1);
    int64_t have = lo + nb;
    if (have <= 0) return 0;
    return (load(0) & ((1ull << have) - 1)) << (-lo);
  }
  uint64_t read(int nb) {  // strict: reading past bit 0 is corruption
    pos -= nb;
    need(pos >= 0);
    return bits(pos, nb);
  }
  uint64_t read_padded(int nb) {  // Huffman weights: zeros past bit 0
    pos -= nb;
    return bits(pos, nb);
  }
};

// ---------------------------------------------------------------- FSE
struct FseEntry {
  uint16_t base;  // next state before its low bits are added
  uint8_t sym;
  uint8_t nb;
};

struct FseTable {
  int log = -1;  // -1: no table yet
  std::vector<FseEntry> t;
};

// RFC 8878 4.1.1: read a normalized distribution; returns bytes consumed.
size_t read_ncount(int16_t* norm, int max_sym, int max_log, int* log_out, int* nsym_out,
                   const uint8_t* src, size_t n) {
  need(n > 0);
  FwdBits b{src, n};
  int log = int(b.read(4)) + 5;
  need(log <= max_log);
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  int sym = 0;
  bool prev0 = false;
  while (remaining > 1 && sym <= max_sym) {
    if (prev0) {
      int n0 = sym;
      for (;;) {
        int r = int(b.read(2));
        n0 += r;
        if (r != 3) break;
        need(n0 <= max_sym);
      }
      need(n0 <= max_sym);
      while (sym < n0) norm[sym++] = 0;
    }
    int max = (2 * threshold - 1) - remaining;
    int count;
    int low = int(b.peek(nbits - 1));
    if (low < max) {
      count = low;
      b.pos += nbits - 1;
    } else {
      count = int(b.peek(nbits));
      if (count >= threshold) count -= max;
      b.pos += nbits;
    }
    count--;  // -1: a "less than one" probability
    remaining -= count < 0 ? -count : count;
    norm[sym++] = int16_t(count);
    prev0 = count == 0;
    while (remaining < threshold) {
      nbits--;
      threshold >>= 1;
    }
  }
  need(remaining == 1);
  need(b.pos <= uint64_t(n) * 8);
  *log_out = log;
  *nsym_out = sym;
  return size_t((b.pos + 7) >> 3);
}

void build_fse(FseTable& T, const int16_t* norm, int nsym, int log) {
  const int size = 1 << log;
  T.log = log;
  T.t.assign(size, FseEntry{0, 0, 0});
  std::vector<uint32_t> next(nsym);
  int high = size - 1;
  for (int s = 0; s < nsym; ++s) {
    if (norm[s] == -1) {
      need(high >= 0);
      T.t[high--].sym = uint8_t(s);
      next[s] = 1;
    } else {
      next[s] = uint32_t(norm[s]);
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (int s = 0; s < nsym; ++s) {
    for (int i = 0; i < norm[s]; ++i) {
      T.t[pos].sym = uint8_t(s);
      do pos = (pos + step) & mask;
      while (pos > high);
    }
  }
  need(pos == 0);
  for (int u = 0; u < size; ++u) {
    uint32_t nx = next[T.t[u].sym]++;
    need(nx > 0);
    int nb = log - highbit(nx);
    T.t[u].nb = uint8_t(nb);
    T.t[u].base = uint16_t((nx << nb) - size);
  }
}

void build_rle(FseTable& T, uint8_t sym) {
  T.log = 0;
  T.t.assign(1, FseEntry{0, sym, 0});
}

// ---------------------------------------------------------------- Huffman
struct HufEntry {
  uint8_t sym;
  uint8_t nb;
};

struct HufTable {
  int max_bits = 0;  // 0: no table yet
  std::vector<HufEntry> t;
};

// RFC 8878 4.2.1: the tree description; returns bytes consumed.
size_t read_huffman_tree(HufTable& H, const uint8_t* src, size_t n) {
  need(n >= 1);
  uint8_t w[260];  // at most 255 decoded weights, then the implied one
  int nw = 0;
  const int hdr = src[0];
  size_t used;
  if (hdr >= 128) {  // direct: 4-bit weights
    nw = hdr - 127;
    size_t bytes = size_t(nw + 1) / 2;
    need(1 + bytes <= n);
    for (int i = 0; i < nw; ++i) {
      uint8_t b = src[1 + i / 2];
      w[i] = (i & 1) ? (b & 15) : (b >> 4);
    }
    used = 1 + bytes;
  } else {  // FSE-compressed weights, two interleaved states
    need(hdr > 0 && size_t(1 + hdr) <= n);
    int16_t norm[256];
    int log, nsym;
    size_t h = read_ncount(norm, 255, 6, &log, &nsym, src + 1, size_t(hdr));
    need(h < size_t(hdr));
    FseTable T;
    build_fse(T, norm, nsym, log);
    BackBits bb;
    bb.init(src + 1 + h, size_t(hdr) - h);
    uint32_t s1 = uint32_t(bb.read(log)), s2 = uint32_t(bb.read(log));
    for (;;) {
      need(nw <= 253);
      const FseEntry& e1 = T.t[s1];
      w[nw++] = e1.sym;
      s1 = e1.base + uint32_t(bb.read_padded(e1.nb));
      if (bb.pos < 0) {
        w[nw++] = T.t[s2].sym;
        break;
      }
      const FseEntry& e2 = T.t[s2];
      w[nw++] = e2.sym;
      s2 = e2.base + uint32_t(bb.read_padded(e2.nb));
      if (bb.pos < 0) {
        w[nw++] = T.t[s1].sym;
        break;
      }
    }
    need(nw <= 255);
    used = 1 + size_t(hdr);
  }
  // the last weight is implied: it completes the sum to a power of two
  uint32_t sum = 0;
  int rank1 = 0;
  for (int i = 0; i < nw; ++i) {
    need(w[i] <= 12);
    if (w[i]) sum += 1u << (w[i] - 1);
    rank1 += w[i] == 1;
  }
  need(sum > 0);
  const int max_bits = highbit(sum) + 1;
  need(max_bits <= 12);
  const uint32_t rest = (1u << max_bits) - sum;
  need((rest & (rest - 1)) == 0);
  w[nw] = uint8_t(highbit(rest) + 1);
  rank1 += w[nw] == 1;
  nw++;
  need(rank1 >= 2 && (rank1 & 1) == 0);
  // codes: by weight, then by symbol; a weight w fills 2^(w-1) slots
  uint32_t start[14] = {0};
  uint32_t counts[14] = {0};
  for (int i = 0; i < nw; ++i) counts[w[i]]++;
  uint32_t acc = 0;
  for (int k = 1; k <= max_bits; ++k) {
    start[k] = acc;
    acc += counts[k] << (k - 1);
  }
  need(acc == (1u << max_bits));
  H.max_bits = max_bits;
  H.t.assign(size_t(1) << max_bits, HufEntry{0, 0});
  for (int s = 0; s < nw; ++s) {
    const int k = w[s];
    if (!k) continue;
    const uint32_t len = 1u << (k - 1);
    for (uint32_t j = 0; j < len; ++j)
      H.t[start[k] + j] = HufEntry{uint8_t(s), uint8_t(max_bits + 1 - k)};
    start[k] += len;
  }
  return used;
}

// One Huffman stream: a 64-bit window of the backward bitstream, refilled
// when fewer than max_bits unread bits are left in it, so a symbol costs one
// shift and one table lookup.
struct HufStream {
  BackBits b;
  int64_t base = 0;  // the window holds bits [base, base + 64)
  uint64_t w = 0;
  void init(const uint8_t* src, size_t n) {
    b.init(src, n);
    refill();
  }
  void refill() {
    const int64_t top = (b.pos + 7) & ~int64_t(7);  // byte-aligned, >= pos
    base = top - 64;
    w = base >= 0 ? b.load(base >> 3) : b.bits(base, 56) | (b.bits(base + 56, 8) << 56);
  }
  inline uint8_t next(const HufEntry* t, int mb, uint64_t mask) {
    if (b.pos - base < mb) refill();
    const HufEntry e = t[(w >> (b.pos - mb - base)) & mask];
    b.pos -= e.nb;  // past bit 0 the window reads zeros; the caller checks pos == 0
    return e.sym;
  }
};

void huf_stream(const HufTable& H, const uint8_t* src, size_t n, uint8_t* out, size_t count) {
  HufStream s;
  s.init(src, n);
  const int mb = H.max_bits;
  const uint64_t mask = (uint64_t(1) << mb) - 1;
  for (size_t i = 0; i < count; ++i) out[i] = s.next(H.t.data(), mb, mask);
  need(s.b.pos == 0);
}

// four streams decoded in one loop, so their lookups overlap
void huf_4streams(const HufTable& H, const uint8_t* const src[4], const size_t n[4],
                  uint8_t* const out[4], const size_t count[4]) {
  HufStream s[4];
  for (int k = 0; k < 4; ++k) s[k].init(src[k], n[k]);
  const int mb = H.max_bits;
  const uint64_t mask = (uint64_t(1) << mb) - 1;
  const HufEntry* t = H.t.data();
  const size_t common = count[3] < count[0] ? count[3] : count[0];  // streams 0-2 are equal
  for (size_t i = 0; i < common; ++i) {
    out[0][i] = s[0].next(t, mb, mask);
    out[1][i] = s[1].next(t, mb, mask);
    out[2][i] = s[2].next(t, mb, mask);
    out[3][i] = s[3].next(t, mb, mask);
  }
  for (int k = 0; k < 4; ++k) {
    for (size_t i = common; i < count[k]; ++i) out[k][i] = s[k].next(t, mb, mask);
    need(s[k].b.pos == 0);
  }
}

// ---------------------------------------------------------------- sequences
constexpr uint32_t kLLBase[36] = {
    0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,   12,   13,   14,    15,    16,    18,
    20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
constexpr uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  1,  1,
                                 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr uint32_t kMLBase[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,  15,   16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,   34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
constexpr uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                                 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
constexpr int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                    2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
constexpr int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
constexpr int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                    1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ---------------------------------------------------------------- frames
constexpr size_t kBlockMax = 128 * 1024;

struct Frame {
  uint8_t* dst;      // the frame's first output byte
  size_t cap;        // room from dst on
  size_t out = 0;    // bytes written
  uint64_t window = 0;
  uint32_t rep[3] = {1, 4, 8};
  HufTable huf;
  FseTable ll, of, ml;
  std::vector<uint8_t> lit;
};

// one table of a sequences section header (mode from the modes byte)
size_t read_table(FseTable& T, int mode, const int16_t* def, int def_n, int def_log, int max_sym,
                  int max_log, const uint8_t* src, size_t n) {
  switch (mode) {
    case 0:
      build_fse(T, def, def_n, def_log);
      return 0;
    case 1:
      need(n >= 1);
      need(src[0] <= max_sym);
      build_rle(T, src[0]);
      return 1;
    case 2: {
      int16_t norm[256];
      int log, nsym;
      size_t used = read_ncount(norm, max_sym, max_log, &log, &nsym, src, n);
      build_fse(T, norm, nsym, log);
      return used;
    }
    default:
      need(T.log >= 0);  // repeat: the previous block's table
      return 0;
  }
}

void copy_out(Frame& F, const uint8_t* src, size_t n) {
  need(n <= F.cap - F.out, kDstTooSmall);
  std::memcpy(F.dst + F.out, src, n);
  F.out += n;
}

void compressed_block(Frame& F, const uint8_t* src, size_t n) {
  const size_t block_start = F.out;
  const uint64_t block_max = F.window < kBlockMax ? F.window : kBlockMax;
  // ---- literals section
  need(n >= 1);
  const int ltype = src[0] & 3, sfmt = (src[0] >> 2) & 3;
  size_t regen, csize = 0, hdr;
  if (ltype < 2) {
    if (sfmt == 0 || sfmt == 2) {
      hdr = 1;
      regen = src[0] >> 3;
    } else if (sfmt == 1) {
      need(n >= 2);
      hdr = 2;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4);
    } else {
      need(n >= 3);
      hdr = 3;
      regen = (src[0] >> 4) + (size_t(src[1]) << 4) + (size_t(src[2]) << 12);
    }
  } else {
    hdr = sfmt < 2 ? 3 : sfmt == 2 ? 4 : 5;
    need(n >= hdr);
    uint64_t v = 0;
    for (size_t i = 0; i < hdr; ++i) v |= uint64_t(src[i]) << (8 * i);
    const int bits = sfmt < 2 ? 10 : sfmt == 2 ? 14 : 18;
    regen = (v >> 4) & ((1u << bits) - 1);
    csize = (v >> (4 + bits)) & ((1u << bits) - 1);
  }
  need(regen <= block_max);
  F.lit.resize(regen);
  size_t p = hdr;
  if (ltype == 0) {
    need(p + regen <= n);
    std::memcpy(F.lit.data(), src + p, regen);
    p += regen;
  } else if (ltype == 1) {
    need(p + 1 <= n);
    std::memset(F.lit.data(), src[p], regen);
    p += 1;
  } else {
    need(p + csize <= n);
    const uint8_t* c = src + p;
    size_t cn = csize;
    if (ltype == 2) {
      size_t t = read_huffman_tree(F.huf, c, cn);
      c += t;
      cn -= t;
    } else {
      need(F.huf.max_bits > 0);  // treeless: the previous block's tree
    }
    if (sfmt == 0) {
      huf_stream(F.huf, c, cn, F.lit.data(), regen);
    } else {
      need(cn >= 10);
      size_t s1 = rd16(c), s2 = rd16(c + 2), s3 = rd16(c + 4);
      need(6 + s1 + s2 + s3 < cn);
      size_t s4 = cn - 6 - s1 - s2 - s3;
      size_t seg = (regen + 3) / 4;
      need(3 * seg <= regen);
      const uint8_t* q = c + 6;
      const uint8_t* const srcs[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
      const size_t sizes[4] = {s1, s2, s3, s4};
      uint8_t* const outs[4] = {F.lit.data(), F.lit.data() + seg, F.lit.data() + 2 * seg,
                                F.lit.data() + 3 * seg};
      const size_t counts[4] = {seg, seg, seg, regen - 3 * seg};
      huf_4streams(F.huf, srcs, sizes, outs, counts);
    }
    p += csize;
  }
  // ---- sequences section
  need(p < n);
  size_t nseq = src[p];
  if (nseq == 0) {
    need(p + 1 == n);
    copy_out(F, F.lit.data(), regen);
    return;
  }
  if (nseq < 128) {
    p += 1;
  } else if (nseq < 255) {
    need(p + 2 <= n);
    nseq = ((nseq - 128) << 8) + src[p + 1];
    p += 2;
  } else {
    need(p + 3 <= n);
    nseq = src[p + 1] + (size_t(src[p + 2]) << 8) + 0x7F00;
    p += 3;
  }
  need(p < n);
  const int modes = src[p++];
  need((modes & 3) == 0);
  p += read_table(F.ll, modes >> 6, kLLDefault, 36, 6, 35, 9, src + p, n - p);
  p += read_table(F.of, (modes >> 4) & 3, kOFDefault, 29, 5, 31, 8, src + p, n - p);
  p += read_table(F.ml, (modes >> 2) & 3, kMLDefault, 53, 6, 52, 9, src + p, n - p);
  need(p < n);
  BackBits b;
  b.init(src + p, n - p);
  uint32_t sll = uint32_t(b.read(F.ll.log)), sof = uint32_t(b.read(F.of.log)),
           sml = uint32_t(b.read(F.ml.log));
  size_t lp = 0;
  for (size_t i = 0; i < nseq; ++i) {
    const FseEntry& el = F.ll.t[sll];
    const FseEntry& eo = F.of.t[sof];
    const FseEntry& em = F.ml.t[sml];
    need(el.sym <= 35 && em.sym <= 52 && eo.sym <= 31);
    const int ofc = eo.sym;
    const uint64_t ov = (uint64_t(1) << ofc) + b.read(ofc);
    const uint64_t ml = kMLBase[em.sym] + b.read(kMLBits[em.sym]);
    const uint64_t ll = kLLBase[el.sym] + b.read(kLLBits[el.sym]);
    uint64_t off;
    if (ov > 3) {
      off = ov - 3;
      F.rep[2] = F.rep[1];
      F.rep[1] = F.rep[0];
      F.rep[0] = uint32_t(off);
    } else {
      const int idx = int(ov - 1) + (ll == 0 ? 1 : 0);
      if (idx == 0) {
        off = F.rep[0];
      } else if (idx == 1) {
        off = F.rep[1];
        F.rep[1] = F.rep[0];
        F.rep[0] = uint32_t(off);
      } else {
        off = idx == 2 ? F.rep[2] : uint64_t(F.rep[0]) - 1;
        F.rep[2] = F.rep[1];
        F.rep[1] = F.rep[0];
        F.rep[0] = uint32_t(off);
      }
    }
    if (i + 1 < nseq) {  // literal-length, match-length, then offset state
      sll = el.base + uint32_t(b.read(el.nb));
      sml = em.base + uint32_t(b.read(em.nb));
      sof = eo.base + uint32_t(b.read(eo.nb));
    }
    need(ll <= regen - lp);
    copy_out(F, F.lit.data() + lp, size_t(ll));
    lp += size_t(ll);
    need(off > 0 && off <= F.out && off <= F.window);
    need(ml <= F.cap - F.out, kDstTooSmall);
    uint8_t* o = F.dst + F.out;
    const uint8_t* m = o - off;
    if (off >= ml) {
      std::memcpy(o, m, size_t(ml));
    } else {
      for (uint64_t j = 0; j < ml; ++j) o[j] = m[j];  // overlapping: a repeat
    }
    F.out += size_t(ml);
  }
  need(b.pos == 0);
  copy_out(F, F.lit.data() + lp, regen - lp);
  need(F.out - block_start <= block_max);
}

struct FrameHeader {
  size_t size;      // header bytes
  int64_t fcs;      // -1 when absent
  uint64_t window;
  bool checksum;
};

FrameHeader frame_header(const uint8_t* src, size_t n) {
  need(n >= 5, kTruncated);
  const int fhd = src[4];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, did_flag = fhd & 3;
  need(((fhd >> 3) & 1) == 0);  // reserved bit
  FrameHeader h{5, -1, 0, bool((fhd >> 2) & 1)};
  if (!single) {
    need(n >= h.size + 1, kTruncated);
    const int wd = src[h.size++];
    const int wlog = 10 + (wd >> 3);
    need(wlog <= 41);
    const uint64_t base = uint64_t(1) << wlog;
    h.window = base + (base / 8) * (wd & 7);
  }
  const size_t did_bytes = did_flag == 3 ? 4 : did_flag;
  need(n >= h.size + did_bytes, kTruncated);
  uint32_t did = 0;
  for (size_t i = 0; i < did_bytes; ++i) did |= uint32_t(src[h.size + i]) << (8 * i);
  need(did == 0, kDictionary);
  h.size += did_bytes;
  const size_t fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : (size_t(1) << fcs_flag);
  need(n >= h.size + fcs_bytes, kTruncated);
  if (fcs_bytes) {
    uint64_t v = 0;
    for (size_t i = 0; i < fcs_bytes; ++i) v |= uint64_t(src[h.size + i]) << (8 * i);
    if (fcs_bytes == 2) v += 256;
    h.fcs = int64_t(v);
    h.size += fcs_bytes;
  }
  if (single) h.window = uint64_t(h.fcs);
  return h;
}

inline bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

// decodes one frame at src into dst; returns input bytes consumed
size_t decode_frame(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, size_t* written) {
  const FrameHeader h = frame_header(src, n);
  Frame F;
  F.dst = dst;
  F.cap = cap;
  F.window = h.window;
  size_t p = h.size;
  for (;;) {
    need(p + 3 <= n, kTruncated);
    const uint32_t bh = rd24(src + p);
    p += 3;
    const bool last = bh & 1;
    const int type = (bh >> 1) & 3;
    const size_t bsize = bh >> 3;
    const uint64_t block_max = F.window < kBlockMax ? F.window : kBlockMax;
    need(type != 3);
    if (type == 1) {  // RLE: one byte, bsize times
      need(bsize <= block_max);
      need(p + 1 <= n, kTruncated);
      need(bsize <= F.cap - F.out, kDstTooSmall);
      std::memset(F.dst + F.out, src[p], bsize);
      F.out += bsize;
      p += 1;
    } else {
      need(bsize <= block_max);
      need(p + bsize <= n, kTruncated);
      if (type == 0) copy_out(F, src + p, bsize);
      else compressed_block(F, src + p, bsize);
      p += bsize;
    }
    if (last) break;
  }
  if (h.fcs >= 0) need(F.out == uint64_t(h.fcs));
  if (h.checksum) {
    need(p + 4 <= n, kTruncated);
    need(rd32(src + p) == uint32_t(xxh64(F.dst, F.out, 0)), kChecksum);
    p += 4;
  }
  *written = F.out;
  return p;
}

// walks the frames' headers and block headers without decoding
int64_t content_size(const uint8_t* src, size_t n) {
  need(n >= 4, kTruncated);
  uint64_t total = 0;
  bool known = true;
  size_t p = 0;
  while (p < n) {
    need(n - p >= 4, kTruncated);
    const uint32_t magic = rd32(src + p);
    if (skippable(magic)) {
      need(n - p >= 8, kTruncated);
      const uint64_t len = rd32(src + p + 4);
      need(len <= n - p - 8, kTruncated);
      p += 8 + size_t(len);
      continue;
    }
    need(magic == 0xFD2FB528u, kBadMagic);
    const FrameHeader h = frame_header(src + p, n - p);
    if (h.fcs < 0) known = false;
    else total += uint64_t(h.fcs);
    p += h.size;
    for (;;) {
      need(n - p >= 3, kTruncated);
      const uint32_t bh = rd24(src + p);
      const size_t body = ((bh >> 1) & 3) == 1 ? 1 : (bh >> 3);
      need(body <= n - p - 3, kTruncated);
      p += 3 + body;
      if (bh & 1) break;
    }
    if (h.checksum) {
      need(n - p >= 4, kTruncated);
      p += 4;
    }
  }
  return known ? int64_t(total) : kUnknownSize;
}

int64_t decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  need(n >= 4, kTruncated);
  size_t p = 0, out = 0;
  while (p < n) {
    need(n - p >= 4, kTruncated);
    const uint32_t magic = rd32(src + p);
    if (skippable(magic)) {
      need(n - p >= 8, kTruncated);
      const uint64_t len = rd32(src + p + 4);
      need(len <= n - p - 8, kTruncated);
      p += 8 + size_t(len);
      continue;
    }
    need(magic == 0xFD2FB528u, kBadMagic);
    size_t w = 0;
    p += decode_frame(src + p, n - p, dst + out, cap - out, &w);
    out += w;
  }
  return int64_t(out);
}

}  // namespace

extern "C" {

int irtpu_zstd_abi_version() { return 1; }

int64_t irtpu_zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap) {
  try {
    return decompress(src, n, dst, cap);
  } catch (const Error& e) {
    return e.code;
  } catch (...) {  // allocation failure
    return kCorrupt;
  }
}

int64_t irtpu_zstd_content_size(const uint8_t* src, size_t n) {
  try {
    return content_size(src, n);
  } catch (const Error& e) {
    return e.code;
  }
}

const char* irtpu_zstd_error_name(int64_t code) {
  switch (code) {
    case kCorrupt: return "corrupt zstd data";
    case kDstTooSmall: return "decoded data larger than expected";
    case kChecksum: return "zstd content checksum mismatch";
    case kDictionary: return "zstd frame needs a dictionary (not supported)";
    case kTruncated: return "truncated zstd data";
    case kBadMagic: return "not a zstd frame (bad magic number)";
    case kUnknownSize: return "zstd frame does not declare its content size";
    default: return "unknown zstd error";
  }
}

uint32_t irtpu_crc32c(const uint8_t* p, size_t n) { return crc32c(p, n); }

}  // extern "C"
