// Zstandard frame decoder (RFC 8878), decode only, for the orbax checkpoint reader
// (convert/zstd.py). Frames with and without a content size, single-segment and
// windowed; skippable frames and frames back to back; raw, RLE and compressed blocks;
// raw, RLE, Huffman and treeless literals with 1 or 4 streams; sequences in predefined,
// RLE, FSE and repeat modes with repeat offsets; the XXH64 content checksum. A frame with
// a dictionary id other than 0, a reserved bit or block type, or any inconsistency raises
// an error: nothing is returned partly decoded.
//
// Built at first use by dusty_gan_v2_tpu_torch/utils/hostbuild.py:
//   g++ -O3 -march=native -fPIC -shared -std=c++17 -o <lib> zstd_decode.cpp
//
// C interface (every function catches its own errors and writes the message to `err`):
//   int zstd_content_size(src, n, uint64_t* total, char* err, size_t errlen)
//       1 and the sum of the frames' declared content sizes, 0 if a frame declares none,
//       -1 on a malformed header.
//   int64_t zstd_decompress(src, n, dst, cap, char* err, size_t errlen)
//       the bytes written, -1 on an error, -2 if the output would exceed `cap`.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct CapacityError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw std::runtime_error(buf);
}

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t(p[1]) << 8); }
inline uint32_t rd24(const uint8_t* p) { return rd16(p) | (uint32_t(p[2]) << 16); }
inline uint32_t rd32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }
inline uint64_t rd64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }  // v > 0

// ------------------------------------------------------------------ XXH64
constexpr uint64_t P1 = 11400714785074694791ULL, P2 = 14029467366897019727ULL, P3 = 1609587929392839161ULL,
                   P4 = 9650029242287828579ULL, P5 = 2870177450012600261ULL;
inline uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
inline uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
inline uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    for (; p + 32 <= end; p += 32) {
      v1 = xround(v1, rd64(p)); v2 = xround(v2, rd64(p + 8));
      v3 = xround(v3, rd64(p + 16)); v4 = xround(v4, rd64(p + 24));
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    h = xmerge(h, v1); h = xmerge(h, v2); h = xmerge(h, v3); h = xmerge(h, v4);
  } else {
    h = P5;
  }
  h += n;
  for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
  if (p + 4 <= end) { h = rotl(h ^ (uint64_t(rd32(p)) * P1), 23) * P2 + P3; p += 4; }
  for (; p < end; ++p) h = rotl(h ^ (*p * P5), 11) * P1;
  h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
  return h;
}

// ------------------------------------------------------------------ bit streams
// Forward stream (FSE table descriptions): bits are taken from the least significant end.
struct ForwardBits {
  const uint8_t* p;
  size_t n, bit = 0;
  uint32_t peek(int nb) const {  // nb <= 24; bits past the end read as 0
    uint64_t w = 0;
    size_t b = bit >> 3;
    for (int i = 0; i < 8 && b + i < n; ++i) w |= uint64_t(p[b + i]) << (8 * i);
    return uint32_t((w >> (bit & 7)) & ((1ULL << nb) - 1));
  }
  void skip(int nb) { bit += nb; }
  size_t bytes_used() const { return (bit + 7) >> 3; }
};

// Backward stream (Huffman, FSE): written forwards, read from its end; the last byte's
// highest set bit marks where the data begins. `pos` counts the bits not yet read; bits
// below the start read as 0 and drive `pos` negative, which the callers check.
struct BackwardBits {
  const uint8_t* p;
  size_t n;
  int64_t pos;
  BackwardBits(const uint8_t* src, size_t size) : p(src), n(size) {
    if (size == 0) fail("zstd: empty bit stream");
    uint8_t last = src[size - 1];
    if (last == 0) fail("zstd: bit stream without its end marker");
    pos = int64_t(size) * 8 - 8 + highbit(last);
  }
  uint64_t peek(int nb) const {  // nb <= 56
    if (nb == 0) return 0;
    int64_t lo = pos - nb;
    if (lo >= 0) {
      size_t b = size_t(lo) >> 3;
      uint64_t w;
      if (b + 8 <= n) {
        w = rd64(p + b);
      } else {
        w = 0;
        for (size_t i = 0; b + i < n; ++i) w |= uint64_t(p[b + i]) << (8 * i);
      }
      return (w >> (lo & 7)) & ((1ULL << nb) - 1);
    }
    if (pos <= 0) return 0;
    uint64_t w = 0;  // bits [0, pos) shifted up by -lo
    for (size_t i = 0; i < 8 && i < n; ++i) w |= uint64_t(p[i]) << (8 * i);
    w &= (1ULL << pos) - 1;
    return w << (-lo);
  }
  uint64_t read(int nb) { uint64_t v = peek(nb); pos -= nb; return v; }
};

// ------------------------------------------------------------------ FSE
struct FseEntry {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseEntry> t;
  bool ok = false;

  void build(const int16_t* norm, int nsym, int accuracy) {
    log = accuracy;
    size_t size = size_t(1) << accuracy;
    t.assign(size, FseEntry{0, 0, 0});
    std::vector<uint32_t> next(nsym);
    int64_t high = int64_t(size) - 1;
    for (int s = 0; s < nsym; ++s) {
      if (norm[s] == -1) {
        if (high < 0) fail("zstd: FSE table overfull");
        t[size_t(high--)].symbol = uint16_t(s);
        next[s] = 1;
      } else {
        next[s] = uint32_t(norm[s]);
      }
    }
    size_t mask = size - 1, step = (size >> 1) + (size >> 3) + 3, pos = 0;
    for (int s = 0; s < nsym; ++s) {
      for (int i = 0; i < norm[s]; ++i) {
        t[pos].symbol = uint16_t(s);
        do pos = (pos + step) & mask; while (int64_t(pos) > high);
      }
    }
    if (pos != 0) fail("zstd: FSE distribution does not fill its table");
    for (size_t u = 0; u < size; ++u) {
      uint32_t x = next[t[u].symbol]++;
      int nb = accuracy - highbit(x);
      t[u].bits = uint8_t(nb);
      t[u].base = uint16_t((x << nb) - size);
    }
    ok = true;
  }

  void rle(int symbol) {
    log = 0;
    t.assign(1, FseEntry{uint16_t(symbol), 0, 0});
    ok = true;
  }

  // reads a table description; returns the bytes it took
  size_t read(const uint8_t* src, size_t n, int max_log, int max_symbol) {
    ForwardBits br{src, n};
    int accuracy = int(br.peek(4)) + 5;
    br.skip(4);
    if (accuracy > max_log) fail("zstd: FSE accuracy log %d above %d", accuracy, max_log);
    int16_t norm[256] = {0};
    int remaining = (1 << accuracy) + 1, threshold = 1 << accuracy, nbits = accuracy + 1, sym = 0;
    bool previous0 = false;
    while (remaining > 1 && sym <= max_symbol) {
      if (previous0) {
        int n0 = sym;
        for (;;) {
          int rep = int(br.peek(2));
          br.skip(2);
          n0 += rep;
          if (rep != 3) break;
        }
        if (n0 > max_symbol + 1) fail("zstd: FSE zero run past the alphabet");
        while (sym < n0) norm[sym++] = 0;
        if (sym > max_symbol) break;
      }
      int max = (2 * threshold - 1) - remaining;
      int count;
      uint32_t bits = br.peek(nbits);
      if (int(bits & (threshold - 1)) < max) {
        count = int(bits & (threshold - 1));
        br.skip(nbits - 1);
      } else {
        count = int(bits & (2 * threshold - 1));
        if (count >= threshold) count -= max;
        br.skip(nbits);
      }
      count--;
      remaining -= count < 0 ? -count : count;
      norm[sym++] = int16_t(count);
      previous0 = count == 0;
      while (remaining < threshold) {
        nbits--;
        threshold >>= 1;
      }
    }
    if (remaining != 1) fail("zstd: corrupt FSE table description");
    if (br.bytes_used() > n) fail("zstd: FSE table description past its block");
    build(norm, sym, accuracy);
    return br.bytes_used();
  }
};

struct FseState {
  const FseTable* tab;
  uint32_t state;
  void init(BackwardBits& bits) { state = uint32_t(bits.read(tab->log)); }
  int symbol() const { return tab->t[state].symbol; }
  void update(BackwardBits& bits) {
    const FseEntry& e = tab->t[state];
    state = e.base + uint32_t(bits.read(e.bits));
  }
};

// ------------------------------------------------------------------ Huffman
struct HufTable {
  int max_bits = 0;
  std::vector<uint16_t> t;  // (symbol << 8) | bits, indexed by the next max_bits bits
  bool ok = false;

  // reads a tree description; returns the bytes it took
  size_t read(const uint8_t* src, size_t n) {
    if (n < 1) fail("zstd: missing Huffman tree description");
    uint8_t weights[256] = {0};
    int nw;
    size_t used;
    uint8_t head = src[0];
    if (head >= 128) {
      nw = head - 127;
      used = 1 + size_t(nw + 1) / 2;
      if (used > n) fail("zstd: Huffman weights past their block");
      for (int i = 0; i < nw; ++i) weights[i] = (i & 1) ? (src[1 + i / 2] & 15) : (src[1 + i / 2] >> 4);
    } else {
      used = 1 + size_t(head);
      if (used > n || head == 0) fail("zstd: Huffman weights past their block");
      FseTable fse;
      size_t h = fse.read(src + 1, head, 6, 255);
      if (h >= head) fail("zstd: Huffman weights without a bit stream");
      BackwardBits bits(src + 1 + h, head - h);
      FseState s1{&fse, 0}, s2{&fse, 0};
      s1.init(bits);
      s2.init(bits);
      nw = 0;
      for (;;) {
        if (nw > 253) fail("zstd: too many Huffman weights");
        weights[nw++] = uint8_t(s1.symbol());
        s1.update(bits);
        if (bits.pos < 0) { weights[nw++] = uint8_t(s2.symbol()); break; }
        weights[nw++] = uint8_t(s2.symbol());
        s2.update(bits);
        if (bits.pos < 0) { weights[nw++] = uint8_t(s1.symbol()); break; }
      }
    }
    uint32_t total = 0;
    for (int i = 0; i < nw; ++i) {
      if (weights[i] > 11) fail("zstd: Huffman weight %d above 11", weights[i]);
      if (weights[i]) total += 1u << (weights[i] - 1);
    }
    if (total == 0) fail("zstd: Huffman weights all zero");
    max_bits = highbit(total) + 1;
    if (max_bits > 11) fail("zstd: Huffman code longer than 11 bits");
    uint32_t rest = (1u << max_bits) - total;
    if (rest & (rest - 1)) fail("zstd: Huffman weights do not close the tree");
    weights[nw++] = uint8_t(highbit(rest) + 1);
    uint32_t rank[13] = {0};
    for (int i = 0; i < nw; ++i) rank[weights[i]]++;
    uint32_t start[13], next = 0;
    for (int w = 1; w <= max_bits; ++w) {
      start[w] = next;
      next += rank[w] << (w - 1);
    }
    t.assign(size_t(1) << max_bits, 0);
    for (int s = 0; s < nw; ++s) {
      int w = weights[s];
      if (!w) continue;
      uint32_t len = (1u << w) >> 1;
      uint16_t e = uint16_t((s << 8) | (max_bits + 1 - w));
      for (uint32_t u = start[w]; u < start[w] + len; ++u) t[u] = e;
      start[w] += len;
    }
    ok = true;
    return used;
  }

  // Decodes `ns` (1 or 4) independent streams together, so that their serial chains of
  // code lengths overlap in the core.
  void decode_streams(int ns, const uint8_t* const* src, const size_t* n, uint8_t* const* out,
                      const size_t* count) const {
    BackwardBits bits[4] = {{src[0], n[0]}, {src[ns > 1 ? 1 : 0], n[ns > 1 ? 1 : 0]},
                            {src[ns > 1 ? 2 : 0], n[ns > 1 ? 2 : 0]}, {src[ns > 1 ? 3 : 0], n[ns > 1 ? 3 : 0]}};
    size_t i[4] = {0, 0, 0, 0};
    const uint32_t mask = (1u << max_bits) - 1;
    // fast path: one 8-byte load holds >= 56 unread bits, enough for five codes of <= 11
    for (;;) {
      bool room = true;
      for (int s = 0; s < ns; ++s) room &= i[s] + 5 <= count[s] && bits[s].pos >= 64;
      if (!room) break;
      for (int s = 0; s < ns; ++s) {
        size_t b = (size_t(bits[s].pos) >> 3) - 7;
        uint64_t w = rd64(src[s] + b);
        int avail = int(bits[s].pos - int64_t(8 * b));
        uint8_t* o = out[s] + i[s];
        for (int k = 0; k < 5; ++k) {
          uint16_t e = t[(w >> (avail - max_bits)) & mask];
          o[k] = uint8_t(e >> 8);
          avail -= e & 255;
        }
        i[s] += 5;
        bits[s].pos = int64_t(8 * b) + avail;
      }
    }
    for (int s = 0; s < ns; ++s) {
      for (; i[s] < count[s]; ++i[s]) {
        uint16_t e = t[bits[s].peek(max_bits)];
        out[s][i[s]] = uint8_t(e >> 8);
        bits[s].pos -= e & 255;
      }
      if (bits[s].pos != 0) fail("zstd: Huffman stream not consumed exactly (%lld bits left)", (long long)bits[s].pos);
    }
  }
};

// ------------------------------------------------------------------ sequences
const int16_t LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {0,  1,  2,  3,  4,  5,  6,   7,   8,   9,   10,   11,   12,   13,   14,    15,    16,    18,
                              20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
                              21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
                              43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

constexpr size_t BLOCK_MAX = 128 * 1024;

struct Output {
  uint8_t* dst;
  size_t cap, pos = 0;
  void need(size_t k) const {
    if (k > cap - pos) throw CapacityError("zstd: output larger than the buffer given");
  }
};

struct FrameState {
  HufTable huf;
  FseTable ll, of, ml;
  uint64_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> literals;
};

// Reads one table of the sequences section into `tab`; returns the bytes it took.
size_t sequence_table(int mode, FseTable& tab, const int16_t* defaults, int ndefault, int default_log, int max_log,
                      int max_symbol, const uint8_t* src, size_t n, const char* name) {
  switch (mode) {
    case 0:
      tab.build(defaults, ndefault, default_log);
      return 0;
    case 1:
      if (n < 1) fail("zstd: %s RLE symbol past its block", name);
      if (src[0] > max_symbol) fail("zstd: %s RLE symbol %d out of range", name, src[0]);
      tab.rle(src[0]);
      return 1;
    case 2:
      return tab.read(src, n, max_log, max_symbol);
    default:
      if (!tab.ok) fail("zstd: %s repeat mode with no earlier table", name);
      return 0;
  }
}

size_t decode_literals(const uint8_t* src, size_t n, FrameState& fs) {
  if (n < 1) fail("zstd: empty literals section");
  int type = src[0] & 3, fmt = (src[0] >> 2) & 3;
  size_t regen, comp = 0, head;
  if (type < 2) {
    if ((fmt & 1) == 0) { regen = src[0] >> 3; head = 1; }
    else if (fmt == 1) { if (n < 2) fail("zstd: truncated literals header"); regen = rd16(src) >> 4; head = 2; }
    else { if (n < 3) fail("zstd: truncated literals header"); regen = rd24(src) >> 4; head = 3; }
    if (regen > BLOCK_MAX) fail("zstd: literals larger than a block");
    fs.literals.resize(regen);
    if (type == 0) {
      if (head + regen > n) fail("zstd: raw literals past their block");
      std::memcpy(fs.literals.data(), src + head, regen);
      return head + regen;
    }
    if (head + 1 > n) fail("zstd: RLE literals past their block");
    std::memset(fs.literals.data(), src[head], regen);
    return head + 1;
  }
  int streams = fmt == 0 ? 1 : 4;
  if (fmt < 2) {
    if (n < 3) fail("zstd: truncated literals header");
    uint32_t v = rd24(src) >> 4;
    regen = v & 0x3FF; comp = v >> 10; head = 3;
  } else if (fmt == 2) {
    if (n < 4) fail("zstd: truncated literals header");
    uint32_t v = rd32(src) >> 4;
    regen = v & 0x3FFF; comp = v >> 14; head = 4;
  } else {
    if (n < 5) fail("zstd: truncated literals header");
    uint64_t v = (uint64_t(rd32(src)) | (uint64_t(src[4]) << 32)) >> 4;
    regen = v & 0x3FFFF; comp = (v >> 18) & 0x3FFFF; head = 5;
  }
  if (regen > BLOCK_MAX) fail("zstd: literals larger than a block");
  if (head + comp > n) fail("zstd: compressed literals past their block");
  const uint8_t* p = src + head;
  size_t left = comp;
  if (type == 2) {
    size_t used = fs.huf.read(p, left);
    p += used;
    left -= used;
  } else if (!fs.huf.ok) {
    fail("zstd: treeless literals with no earlier Huffman table");
  }
  fs.literals.resize(regen);
  uint8_t* out = fs.literals.data();
  if (streams == 1) {
    fs.huf.decode_streams(1, &p, &left, &out, &regen);
  } else {
    if (left < 6) fail("zstd: truncated jump table");
    size_t s1 = rd16(p), s2 = rd16(p + 2), s3 = rd16(p + 4);
    if (6 + s1 + s2 + s3 > left) fail("zstd: jump table past its literals");
    size_t s4 = left - 6 - s1 - s2 - s3, per = (regen + 3) / 4;
    if (3 * per > regen) fail("zstd: too few literals for four streams");
    const uint8_t* q = p + 6;
    const uint8_t* srcs[4] = {q, q + s1, q + s1 + s2, q + s1 + s2 + s3};
    size_t sizes[4] = {s1, s2, s3, s4}, counts[4] = {per, per, per, regen - 3 * per};
    uint8_t* outs[4] = {out, out + per, out + 2 * per, out + 3 * per};
    fs.huf.decode_streams(4, srcs, sizes, outs, counts);
  }
  return head + comp;
}

void copy_match(Output& o, size_t frame_start, uint64_t offset, size_t length) {
  if (offset == 0 || offset > o.pos - frame_start) fail("zstd: match offset %llu reaches before the frame",
                                                        (unsigned long long)offset);
  o.need(length);
  uint8_t* d = o.dst + o.pos;
  const uint8_t* s = d - offset;
  if (offset >= length) {
    std::memcpy(d, s, length);
  } else if (offset >= 8) {
    for (size_t i = 0; i < length; i += 8) std::memcpy(d + i, s + i, length - i < 8 ? length - i : 8);
  } else {
    for (size_t i = 0; i < length; ++i) d[i] = s[i];
  }
  o.pos += length;
}

void decode_compressed_block(const uint8_t* src, size_t n, FrameState& fs, Output& o, size_t frame_start) {
  size_t lit_bytes = decode_literals(src, n, fs);
  const uint8_t* p = src + lit_bytes;
  size_t left = n - lit_bytes;
  if (left < 1) fail("zstd: missing sequences section");
  size_t nseq = p[0];
  size_t head;
  if (nseq < 128) head = 1;
  else if (nseq < 255) { if (left < 2) fail("zstd: truncated sequence count"); nseq = ((nseq - 128) << 8) + p[1]; head = 2; }
  else { if (left < 3) fail("zstd: truncated sequence count"); nseq = rd16(p + 1) + 0x7F00; head = 3; }
  p += head;
  left -= head;
  const uint8_t* lit = fs.literals.data();
  size_t lit_left = fs.literals.size();
  if (nseq == 0) {
    if (left != 0) fail("zstd: bytes after an empty sequences section");
    o.need(lit_left);
    std::memcpy(o.dst + o.pos, lit, lit_left);
    o.pos += lit_left;
    return;
  }
  if (left < 1) fail("zstd: missing symbol compression modes");
  uint8_t modes = p[0];
  if (modes & 3) fail("zstd: reserved bits set in the symbol compression modes");
  p++;
  left--;
  size_t k = sequence_table(modes >> 6, fs.ll, LL_DEFAULT, 36, 6, 9, 35, p, left, "literal length");
  p += k; left -= k;
  k = sequence_table((modes >> 4) & 3, fs.of, OF_DEFAULT, 29, 5, 8, 31, p, left, "offset");
  p += k; left -= k;
  k = sequence_table((modes >> 2) & 3, fs.ml, ML_DEFAULT, 53, 6, 9, 52, p, left, "match length");
  p += k; left -= k;
  BackwardBits bits(p, left);
  FseState sll{&fs.ll, 0}, sof{&fs.of, 0}, sml{&fs.ml, 0};
  sll.init(bits);
  sof.init(bits);
  sml.init(bits);
  uint64_t* rep = fs.rep;
  for (size_t i = 0; i < nseq; ++i) {
    int ofc = sof.symbol(), mlc = sml.symbol(), llc = sll.symbol();
    if (ofc > 31) fail("zstd: offset code %d out of range", ofc);
    uint64_t ofv = (uint64_t(1) << ofc) + bits.read(ofc);
    size_t ml = ML_BASE[mlc] + size_t(bits.read(ML_BITS[mlc]));
    size_t ll = LL_BASE[llc] + size_t(bits.read(LL_BITS[llc]));
    uint64_t offset;
    if (ofv > 3) {
      offset = ofv - 3;
      rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = offset;
    } else {
      int idx = int(ofv) - 1 + (ll == 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx == 3 ? rep[0] - 1 : rep[idx];
        if (idx != 1) rep[2] = rep[1];
        rep[1] = rep[0];
        rep[0] = offset;
      }
    }
    if (i + 1 < nseq) {
      sll.update(bits);
      sml.update(bits);
      sof.update(bits);
    }
    if (bits.pos < 0) fail("zstd: sequence bit stream overread");
    if (ll > lit_left) fail("zstd: a sequence takes more literals than remain");
    o.need(ll);
    std::memcpy(o.dst + o.pos, lit, ll);
    o.pos += ll;
    lit += ll;
    lit_left -= ll;
    copy_match(o, frame_start, offset, ml);
  }
  if (bits.pos != 0) fail("zstd: sequence bit stream not consumed exactly (%lld bits left)", (long long)bits.pos);
  o.need(lit_left);
  std::memcpy(o.dst + o.pos, lit, lit_left);
  o.pos += lit_left;
}

struct FrameHeader {
  size_t size;            // bytes of the header, magic included
  bool has_size, checksum;
  uint64_t content_size;
};

FrameHeader frame_header(const uint8_t* src, size_t n) {
  if (n < 5) fail("zstd: truncated frame header");
  uint8_t fhd = src[4];
  int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, dict_flag = fhd & 3;
  if (fhd & 8) fail("zstd: reserved bit set in the frame header");
  size_t pos = 5 + (single ? 0 : 1);
  size_t dict_size = dict_flag == 3 ? 4 : size_t(dict_flag);
  size_t fcs_size = fcs_flag == 0 ? (single ? 1 : 0) : (size_t(1) << fcs_flag);
  if (pos + dict_size + fcs_size > n) fail("zstd: truncated frame header");
  uint64_t dict = 0;
  for (size_t i = 0; i < dict_size; ++i) dict |= uint64_t(src[pos + i]) << (8 * i);
  if (dict != 0) fail("zstd: frame needs dictionary %llu; dictionaries are not supported", (unsigned long long)dict);
  pos += dict_size;
  uint64_t fcs = 0;
  for (size_t i = 0; i < fcs_size; ++i) fcs |= uint64_t(src[pos + i]) << (8 * i);
  if (fcs_size == 2) fcs += 256;
  pos += fcs_size;
  return FrameHeader{pos, fcs_size > 0, bool((fhd >> 2) & 1), fcs};
}

constexpr uint32_t MAGIC = 0xFD2FB528u;

bool skippable(uint32_t magic) { return (magic & 0xFFFFFFF0u) == 0x184D2A50u; }

// Decodes one frame at src; returns the bytes it took.
size_t decode_frame(const uint8_t* src, size_t n, Output& o) {
  FrameHeader h = frame_header(src, n);
  size_t frame_start = o.pos, pos = h.size;
  FrameState fs;
  for (;;) {
    if (pos + 3 > n) fail("zstd: truncated block header");
    uint32_t bh = rd24(src + pos);
    pos += 3;
    bool last = bh & 1;
    int type = (bh >> 1) & 3;
    size_t size = bh >> 3;
    if (type == 3) fail("zstd: reserved block type");
    if (size > BLOCK_MAX) fail("zstd: block of %zu bytes above the 128 KiB limit", size);
    if (type == 1) {
      if (pos + 1 > n) fail("zstd: truncated RLE block");
      o.need(size);
      std::memset(o.dst + o.pos, src[pos], size);
      o.pos += size;
      pos += 1;
    } else {
      if (pos + size > n) fail("zstd: block past the end of the input");
      if (type == 0) {
        o.need(size);
        std::memcpy(o.dst + o.pos, src + pos, size);
        o.pos += size;
      } else {
        size_t before = o.pos;
        decode_compressed_block(src + pos, size, fs, o, frame_start);
        if (o.pos - before > BLOCK_MAX) fail("zstd: block decodes to more than 128 KiB");
      }
      pos += size;
    }
    if (last) break;
  }
  size_t got = o.pos - frame_start;
  if (h.has_size && got != h.content_size)
    fail("zstd: frame decodes to %zu bytes, its header says %llu", got, (unsigned long long)h.content_size);
  if (h.checksum) {
    if (pos + 4 > n) fail("zstd: truncated content checksum");
    uint32_t want = rd32(src + pos);
    if (uint32_t(xxh64(o.dst + frame_start, got)) != want) fail("zstd: content checksum mismatch");
    pos += 4;
  }
  return pos;
}

size_t skip_frame(const uint8_t* src, size_t n) {
  if (n < 8) fail("zstd: truncated skippable frame");
  size_t size = rd32(src + 4);
  if (8 + size > n) fail("zstd: skippable frame past the end of the input");
  return 8 + size;
}

void set_error(char* err, size_t errlen, const char* msg) {
  if (err && errlen) {
    std::strncpy(err, msg, errlen - 1);
    err[errlen - 1] = 0;
  }
}

}  // namespace

extern "C" int zstd_content_size(const uint8_t* src, size_t n, uint64_t* total, char* err, size_t errlen) {
  try {
    uint64_t sum = 0;
    for (size_t pos = 0; pos < n;) {
      if (n - pos < 4) fail("zstd: %zu stray bytes at the end of the input", n - pos);
      uint32_t magic = rd32(src + pos);
      if (skippable(magic)) { pos += skip_frame(src + pos, n - pos); continue; }
      if (magic != MAGIC) fail("zstd: bad magic 0x%08x at offset %zu", magic, pos);
      FrameHeader h = frame_header(src + pos, n - pos);
      if (!h.has_size) return 0;
      sum += h.content_size;
      // the frame's end is found by walking its block headers
      size_t p = pos + h.size;
      for (;;) {
        if (p + 3 > n) fail("zstd: truncated block header");
        uint32_t bh = rd24(src + p);
        int type = (bh >> 1) & 3;
        p += 3 + (type == 1 ? 1 : (bh >> 3));
        if (bh & 1) break;
      }
      pos = p + (h.checksum ? 4 : 0);
    }
    *total = sum;
    return 1;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}

extern "C" int64_t zstd_decompress(const uint8_t* src, size_t n, uint8_t* dst, size_t cap, char* err,
                                   size_t errlen) {
  Output o{dst, cap};
  try {
    if (n == 0) fail("zstd: empty input");
    for (size_t pos = 0; pos < n;) {
      if (n - pos < 4) fail("zstd: %zu stray bytes at the end of the input", n - pos);
      uint32_t magic = rd32(src + pos);
      if (skippable(magic)) pos += skip_frame(src + pos, n - pos);
      else if (magic == MAGIC) pos += decode_frame(src + pos, n - pos, o);
      else fail("zstd: bad magic 0x%08x at offset %zu", magic, pos);
    }
    return int64_t(o.pos);
  } catch (const CapacityError& e) {
    set_error(err, errlen, e.what());
    return -2;
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
    return -1;
  }
}
