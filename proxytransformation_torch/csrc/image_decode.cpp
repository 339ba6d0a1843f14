// Host image decoders for the data pipeline: JPEG and the PNG unfilter
// step.
//
// The JAX package reads its views with cv2 (libjpeg-turbo, libpng). The
// port's batches must equal its batches byte for byte, so this decoder
// follows libjpeg-turbo's default decompression exactly:
//   - sequential (SOF0 / SOF1) and progressive (SOF2) Huffman scans, 8-bit
//     samples, restart intervals in either; a sequential block goes through
//     the IDCT as it is decoded, a progressive scan decodes into one
//     coefficient buffer per component (jdphuff.c's DC first / refine and
//     AC first / refine with EOB runs) and the IDCT runs once all scans
//     are in; each component takes the quantization table it latched at
//     its first scan (jdinput.c::latch_quant_tables);
//   - the `islow` integer IDCT of jidctint.c with the range-limit table of
//     jdmaster.c::prepare_range_limit_table;
//   - "fancy" upsampling of jdsample.c: the h2v1, h1v2 and h2v2 triangle
//     filters with their rounding biases, box replication for components
//     two samples wide or narrower (where libjpeg-turbo drops to the box
//     filter) and for other integral factors; rows past the edge repeat
//     the last real row (jdmainct.c::set_bottom_pointers);
//   - the color space as jdapimin.c::default_decompress_parms guesses it:
//     YCbCr -> BGR with the fixed-point tables of jdcolor.c, RGB (Adobe
//     transform 0, or the component ids 'R' 'G' 'B' without a JFIF or
//     Adobe marker) reordered, CMYK as stored, YCCK -> CMYK by jdcolor.c's
//     ycck_cmyk_convert; CMYK -> BGR as OpenCV's icvCvt_CMYK2BGR_8u_C4C3R
//     does (c = k - ((255 - c) * k >> 8), and so for m and y);
//   - one-component images replicated to three channels, as cv2's
//     IMREAD_COLOR does.
// What it does not decode it refuses with a message naming the feature:
// lossless, hierarchical or arithmetic-coded JPEG, 12-bit samples, a
// height defined by DNL, and a progressive file whose scans leave one of
// the first ten coefficients unrefined (libjpeg then smooths the blocks,
// jdcoefct.c::decompress_smooth_data). It reports the EXIF orientation and
// leaves the image unrotated; the caller turns it as cv2 does.
//
// A plain C interface for ctypes; every function is reentrant and works on
// caller-owned buffers. Build: c++ -O2 -fPIC -shared -std=c++17.
#include <algorithm>
#include <cstdint>
#include <exception>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct DecodeError {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw DecodeError{msg}; }

// zigzag index -> natural index, with libjpeg's 16 extra entries so that a
// run past the end of a corrupt block lands on 63
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman
constexpr int kLookBits = 9;

struct HuffTable {
  bool defined = false;
  // lookahead: (length << 8) | value, 0 when the code is longer
  uint16_t look[1 << kLookBits];
  int32_t maxcode[18];   // largest code of each length, -1 if none
  int32_t valoffset[18]; // value index = code + valoffset[l]
  uint8_t values[256];

  void build(const uint8_t* bits, const uint8_t* vals, int nvals) {
    std::memcpy(values, vals, nvals);
    std::memset(look, 0, sizeof(look));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valoffset[l] = k - code;
      if (bits[l - 1]) {
        for (int i = 0; i < bits[l - 1]; ++i, ++code, ++k) {
          if (code >= (1 << l)) fail("corrupt JPEG: bad Huffman table");
          if (l <= kLookBits) {
            const int shift = kLookBits - l;
            for (int j = 0; j < (1 << shift); ++j)
              look[(code << shift) | j] =
                  static_cast<uint16_t>((l << 8) | values[k]);
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7FFFFFFF;
    defined = true;
  }
};

// --------------------------------------------------------- entropy input
struct BitReader {
  const uint8_t* buf;
  size_t len;
  size_t pos;
  uint64_t acc = 0;  // bits left-aligned in the low `nbits`
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && pos < len) {
        byte = buf[pos];
        if (byte == 0xFF) {
          const uint32_t next = pos + 1 < len ? buf[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            at_marker = true;  // leave the marker for the parser
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      // past a marker libjpeg feeds zero bits
      acc = (acc << 8) | byte;
      nbits += 8;
    }
  }

  int get(int n) {  // n in 1..16
    if (nbits < n) fill();
    nbits -= n;
    return static_cast<int>((acc >> nbits) & ((1u << n) - 1));
  }

  int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>((acc >> (nbits - n)) & ((1u << n) - 1));
  }

  int decode(const HuffTable& t) {
    const int look = t.look[peek(kLookBits)];
    if (look) {
      nbits -= look >> 8;
      return look & 0xFF;
    }
    int code = get(kLookBits);
    int l = kLookBits;
    while (code > t.maxcode[l]) {
      code = (code << 1) | get(1);
      if (++l > 16) fail("corrupt JPEG: bad Huffman code");
    }
    return t.values[code + t.valoffset[l]];
  }

  // restart: drop the buffered bits and consume the RSTn marker
  void restart(int expected) {
    acc = 0;
    nbits = 0;
    at_marker = false;
    while (pos + 1 < len) {
      if (buf[pos] == 0xFF && buf[pos + 1] >= 0xD0 && buf[pos + 1] <= 0xD7) {
        if (buf[pos + 1] - 0xD0 != expected)
          fail("corrupt JPEG: restart markers out of order");
        pos += 2;
        return;
      }
      ++pos;
    }
    fail("corrupt JPEG: missing restart marker");
  }
};

inline int extend(int v, int s) {  // HUFF_EXTEND
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ------------------------------------------------------------ islow IDCT
constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t{1} << (n - 1))) >> n; }

// jdmaster.c's post-IDCT table: out = limit[x & 1023], x the descaled
// sample before the +128 level shift
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) idct[i] = static_cast<uint8_t>(i + 128);
      else if (i < 512) idct[i] = 255;
      else if (i < 896) idct[i] = 0;
      else idct[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const int16_t* qt = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      const int64_t dc = static_cast<int64_t>(in[0]) * qt[0] * (1 << kPass1Bits);
      for (int r = 0; r < 8; ++r) w[r * 8] = static_cast<int>(dc);
      continue;
    }
    int64_t z2 = static_cast<int64_t>(in[16]) * qt[16];
    int64_t z3 = static_cast<int64_t>(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = static_cast<int64_t>(in[0]) * qt[0];
    z3 = static_cast<int64_t>(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(in[56]) * qt[56];
    tmp1 = static_cast<int64_t>(in[40]) * qt[40];
    tmp2 = static_cast<int64_t>(in[24]) * qt[24];
    tmp3 = static_cast<int64_t>(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int s = kConstBits - kPass1Bits;
    w[0] = (int)descale(tmp10 + tmp3, s);
    w[56] = (int)descale(tmp10 - tmp3, s);
    w[8] = (int)descale(tmp11 + tmp2, s);
    w[48] = (int)descale(tmp11 - tmp2, s);
    w[16] = (int)descale(tmp12 + tmp1, s);
    w[40] = (int)descale(tmp12 - tmp1, s);
    w[24] = (int)descale(tmp13 + tmp0, s);
    w[32] = (int)descale(tmp13 - tmp0, s);
  }
  constexpr int s2 = kConstBits + kPass1Bits + 3;
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      const uint8_t v = kRange.idct[static_cast<int>(descale(w[0], kPass1Bits + 3)) & 1023];
      std::memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (static_cast<int64_t>(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (static_cast<int64_t>(w[0]) - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.idct[static_cast<int>(descale(tmp10 + tmp3, s2)) & 1023];
    o[7] = kRange.idct[static_cast<int>(descale(tmp10 - tmp3, s2)) & 1023];
    o[1] = kRange.idct[static_cast<int>(descale(tmp11 + tmp2, s2)) & 1023];
    o[6] = kRange.idct[static_cast<int>(descale(tmp11 - tmp2, s2)) & 1023];
    o[2] = kRange.idct[static_cast<int>(descale(tmp12 + tmp1, s2)) & 1023];
    o[5] = kRange.idct[static_cast<int>(descale(tmp12 - tmp1, s2)) & 1023];
    o[3] = kRange.idct[static_cast<int>(descale(tmp13 + tmp0, s2)) & 1023];
    o[4] = kRange.idct[static_cast<int>(descale(tmp13 - tmp0, s2)) & 1023];
  }
}

// ---------------------------------------------------------------- decoder
struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int width = 0, height = 0;  // downsampled size in samples
  int stride = 0, rows = 0;   // plane size, whole blocks
  int bw = 0, bh = 0;         // coefficient blocks, whole MCUs
  std::vector<uint8_t> plane;
  std::vector<int16_t> coef;  // progressive: bw * bh blocks of 64
  int16_t q[64];              // the table latched at the first scan
  bool seen = false;          // decoded by some scan
  int coef_bits[64];          // progressive: the Al last coded, -1: none
  int dc_table = 0, ac_table = 0;

  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * bw + bx) * 64;
  }
};

struct Jpeg {
  const uint8_t* buf;
  size_t len;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1;
  int restart_interval = 0;
  bool have_frame = false, progressive = false;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
  int16_t qt[4][64];  // libjpeg keeps them as short (ISLOW_MULT_TYPE)
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  Component comp[4];

  Jpeg(const uint8_t* b, size_t n) : buf(b), len(n) {}

  int u8() {
    if (pos >= len) fail("corrupt JPEG: unexpected end of file");
    return buf[pos++];
  }
  int u16() {
    const int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() {
    // skip to 0xFF, then past fill bytes
    while (true) {
      int b = u8();
      if (b != 0xFF) continue;
      do { b = u8(); } while (b == 0xFF);
      if (b != 0) return b;
    }
  }

  void parse_exif(const uint8_t* p, size_t n) {
    if (n < 14 || std::memcmp(p, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = p + 6;
    const size_t tn = n - 6;
    const bool le = t[0] == 'I';
    auto rd16 = [&](size_t o) -> uint32_t {
      if (o + 2 > tn) fail("corrupt JPEG: EXIF block truncated");
      return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]);
    };
    auto rd32 = [&](size_t o) -> uint32_t {
      if (o + 4 > tn) fail("corrupt JPEG: EXIF block truncated");
      return le ? (t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) |
                   (static_cast<uint32_t>(t[o + 3]) << 24))
                : ((static_cast<uint32_t>(t[o]) << 24) | (t[o + 1] << 16) |
                   (t[o + 2] << 8) | t[o + 3]);
    };
    const size_t ifd = rd32(4);
    const uint32_t count = rd16(ifd);
    for (uint32_t i = 0; i < count; ++i) {
      const size_t e = ifd + 2 + 12 * i;
      if (rd16(e) == 0x0112) orientation = static_cast<int>(rd16(e + 8));
    }
  }

  void parse_headers() {
    if (len < 4 || buf[0] != 0xFF || buf[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    while (true) {
      const int m = next_marker();
      if (m == 0xDA) return;  // SOS: the caller decodes the scan
      if (m == 0xD9) fail("corrupt JPEG: no scan before EOI");
      if (m >= 0xD0 && m <= 0xD7) continue;
      read_segment(m);
    }
  }

  void read_segment(int m) {
    const size_t seg_len = static_cast<size_t>(u16());
    if (seg_len < 2 || pos + seg_len - 2 > len)
      fail("corrupt JPEG: bad segment length");
    const size_t end = pos + seg_len - 2;
    switch (m) {
      case 0xC0:
      case 0xC1: read_sof(end); break;
      case 0xC2:
        progressive = true;
        read_sof(end);
        break;
      case 0xC3: case 0xC7: case 0xCB: case 0xCF:
        fail("lossless JPEG is not supported");
      case 0xC5: case 0xC6: case 0xCD: case 0xCE:
        fail("hierarchical JPEG is not supported");
      case 0xC9: case 0xCA: case 0xCC:
        fail("arithmetic-coded JPEG is not supported");
      case 0xC4: read_dht(end); break;
      case 0xDB: read_dqt(end); break;
      case 0xDD:
        restart_interval = u16();
        break;
      case 0xE0:
        if (end - pos >= 5 && std::memcmp(buf + pos, "JFIF\0", 5) == 0)
          saw_jfif = true;
        break;
      case 0xE1: parse_exif(buf + pos, end - pos); break;
      case 0xEE:
        if (end - pos >= 12 && std::memcmp(buf + pos, "Adobe", 5) == 0) {
          saw_adobe = true;
          adobe_transform = buf[pos + 11];
        }
        break;
      default: break;
    }
    pos = end;
  }

  void read_sof(size_t end) {
    if (have_frame) fail("corrupt JPEG: two frame headers");
    const int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit JPEG is not supported");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height <= 0) fail("JPEG with a height defined by DNL is not supported");
    if (width <= 0) fail("corrupt JPEG: zero width");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("JPEG with " + std::to_string(ncomp) + " components is not supported");
    if (pos + 3 * ncomp > end) fail("corrupt JPEG: bad frame header");
    for (int c = 0; c < ncomp; ++c) {
      comp[c].id = u8();
      const int hv = u8();
      comp[c].h = hv >> 4;
      comp[c].v = hv & 15;
      comp[c].tq = u8();
      if (comp[c].h < 1 || comp[c].h > 4 || comp[c].v < 1 || comp[c].v > 4 ||
          comp[c].tq > 3)
        fail("corrupt JPEG: bad sampling factors");
      hmax = std::max(hmax, comp[c].h);
      vmax = std::max(vmax, comp[c].v);
    }
    if (static_cast<int64_t>(width) * height > (1LL << 28))
      fail("JPEG too large");
    const int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    const int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.width = (width * k.h + hmax - 1) / hmax;
      k.height = (height * k.v + vmax - 1) / vmax;
      k.stride = mcux * k.h * 8;
      k.rows = mcuy * k.v * 8;
      k.bw = mcux * k.h;
      k.bh = mcuy * k.v;
      k.plane.assign(static_cast<size_t>(k.stride) * k.rows, 0);
      if (progressive)
        k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
      std::fill(k.coef_bits, k.coef_bits + 64, -1);
    }
    have_frame = true;
  }

  void read_dht(size_t end) {
    while (pos < end) {
      const int tc_th = u8();
      const int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("corrupt JPEG: bad Huffman table id");
      uint8_t bits[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) {
        bits[i] = static_cast<uint8_t>(u8());
        total += bits[i];
      }
      if (total > 256 || pos + total > end)
        fail("corrupt JPEG: bad Huffman table");
      (tc ? ac[th] : dc[th]).build(bits, buf + pos, total);
      pos += total;
    }
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      const int pq_tq = u8();
      const int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("corrupt JPEG: bad quantization table");
      for (int i = 0; i < 64; ++i)
        qt[tq][kNaturalOrder[i]] = static_cast<int16_t>(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
  }

  // ------------------------------------------------------ entropy decoding
  // one block of a sequential scan (jdhuff.c::decode_mcu)
  void block_sequential(BitReader& br, const Component& k, int& pred,
                        int16_t* block) {
    std::memset(block, 0, 64 * sizeof(int16_t));
    int s = br.decode(dc[k.dc_table]);
    int diff = 0;
    if (s) {
      if (s > 16) fail("corrupt JPEG: bad DC magnitude");
      diff = extend(br.get(s), s);
    }
    pred += diff;
    block[0] = static_cast<int16_t>(pred);
    const HuffTable& at = ac[k.ac_table];
    for (int z = 1; z < 64; ++z) {
      const int rs = br.decode(at);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        z += r;
        block[kNaturalOrder[z]] = static_cast<int16_t>(extend(br.get(s), s));
      } else {
        if (r != 15) break;
        z += 15;
      }
    }
  }

  // jdphuff.c::decode_mcu_DC_first / decode_mcu_DC_refine
  void block_dc_first(BitReader& br, const Component& k, int& pred, int al,
                      int16_t* block) {
    int s = br.decode(dc[k.dc_table]);
    if (s) {
      if (s > 16) fail("corrupt JPEG: bad DC magnitude");
      s = extend(br.get(s), s);
    }
    pred += s;
    block[0] = static_cast<int16_t>(pred * (1 << al));
  }

  // jdphuff.c::decode_mcu_AC_first
  void block_ac_first(BitReader& br, const Component& k, int ss, int se,
                      int al, int& eobrun, int16_t* block) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const HuffTable& at = ac[k.ac_table];
    for (int z = ss; z <= se; ++z) {
      const int rs = br.decode(at);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        z += r;
        if (z > 63) fail("corrupt JPEG: AC run past the block");
        block[kNaturalOrder[z]] =
            static_cast<int16_t>(extend(br.get(s), s) * (1 << al));
      } else if (r == 15) {
        z += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.get(r);
        --eobrun;
        break;
      }
    }
  }

  // jdphuff.c::decode_mcu_AC_refine
  void block_ac_refine(BitReader& br, const Component& k, int ss, int se,
                       int al, int& eobrun, int16_t* block) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int z = ss;
    auto correct = [&](int16_t& c) {
      if (br.get(1) && (c & p1) == 0)
        c = static_cast<int16_t>(c + (c >= 0 ? p1 : m1));
    };
    if (eobrun == 0) {
      const HuffTable& at = ac[k.ac_table];
      for (; z <= se; ++z) {
        const int rs = br.decode(at);
        int r = rs >> 4;
        int s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt JPEG: bad refinement code");
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        // pass the nonzero coefficients (correcting each) and r zeros
        do {
          int16_t& c = block[kNaturalOrder[z]];
          if (c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          ++z;
        } while (z <= se);
        if (s) block[kNaturalOrder[z]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; z <= se; ++z) {
        int16_t& c = block[kNaturalOrder[z]];
        if (c != 0) correct(c);
      }
      --eobrun;
    }
  }

  // decode one scan into the coefficient buffers; `pos` is just past the
  // SOS marker
  void decode_scan() {
    if (!have_frame) fail("corrupt JPEG: scan before frame header");
    const size_t seg_len = static_cast<size_t>(u16());
    const size_t end = pos + seg_len - 2;
    const int ns = u8();
    if (ns < 1 || ns > ncomp) fail("corrupt JPEG: bad scan header");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int cid = u8();
      const int tables = u8();
      sc[i] = nullptr;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == cid) sc[i] = &comp[c];
      if (!sc[i]) fail("corrupt JPEG: scan names an unknown component");
      sc[i]->dc_table = tables >> 4;
      sc[i]->ac_table = tables & 15;
      if (sc[i]->dc_table > 3 || sc[i]->ac_table > 3)
        fail("corrupt JPEG: bad Huffman table id");
    }
    const int ss = u8(), se = u8(), ahal = u8();
    const int ah = ahal >> 4, al = ahal & 15;
    pos = end;
    const bool dc_band = ss == 0;
    if (progressive) {
      if ((dc_band && se != 0) ||
          (!dc_band && (se < ss || se > 63 || ns != 1)) ||
          (ah != 0 && al != ah - 1) || al > 13)
        fail("corrupt JPEG: bad progression parameters");
    } else if (ss != 0 || se != 63 || ahal != 0) {
      fail("corrupt JPEG: spectral selection in a sequential scan");
    }
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      const bool need_dc = !progressive || (dc_band && ah == 0);
      const bool need_ac = !progressive || !dc_band;
      if ((need_dc && !dc[k.dc_table].defined) ||
          (need_ac && !ac[k.ac_table].defined))
        fail("corrupt JPEG: scan uses an undefined Huffman table");
      if (!k.seen) {  // latch the quantization table
        if (!qt_defined[k.tq])
          fail("corrupt JPEG: component uses an undefined quantization "
               "table");
        std::memcpy(k.q, qt[k.tq], sizeof(k.q));
      }
      k.seen = true;
      if (progressive)
        for (int z = ss; z <= se; ++z) k.coef_bits[z] = al;
    }

    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = (sc[0]->width + 7) / 8;
      mcus_y = (sc[0]->height + 7) / 8;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    }
    BitReader br{buf, len, pos};
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0;
    int16_t seq_block[64];
    int todo = restart_interval, next_rst = 0;
    const int total = mcus_x * mcus_y;
    for (int m = 0; m < total; ++m) {
      if (restart_interval && todo == 0) {
        br.restart(next_rst);
        next_rst = (next_rst + 1) & 7;
        todo = restart_interval;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
      }
      const int mx = m % mcus_x, my = m / mcus_x;
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        const int bh = ns == 1 ? 1 : k.h, bv = ns == 1 ? 1 : k.v;
        for (int by = 0; by < bv; ++by) {
          for (int bx = 0; bx < bh; ++bx) {
            const int bx_all = mx * bh + bx, by_all = my * bv + by;
            if (!progressive) {  // one scan holds all: no buffer
              block_sequential(br, k, pred[i], seq_block);
              idct_islow(seq_block, k.q,
                         k.plane.data() + static_cast<size_t>(by_all) * 8 *
                                              k.stride + bx_all * 8,
                         k.stride);
              continue;
            }
            int16_t* block = k.block(bx_all, by_all);
            if (dc_band && ah == 0)
              block_dc_first(br, k, pred[i], al, block);
            else if (dc_band)
              block[0] = static_cast<int16_t>(block[0] | (br.get(1) << al));
            else if (ah == 0)
              block_ac_first(br, k, ss, se, al, eobrun, block);
            else
              block_ac_refine(br, k, ss, se, al, eobrun, block);
          }
        }
      }
      --todo;
    }
    // skip to the marker that ends the entropy-coded segment
    pos = br.pos;
    while (pos + 1 < len &&
           !(buf[pos] == 0xFF && buf[pos + 1] != 0 &&
             !(buf[pos + 1] >= 0xD0 && buf[pos + 1] <= 0xD7)))
      ++pos;
  }

  void decode_all() {
    parse_headers();
    check_supported();
    while (true) {
      decode_scan();
      const int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) continue;
      if (m >= 0xD0 && m <= 0xD7) continue;
      read_segment(m);
      while (true) {  // more tables before the next scan
        const int m2 = next_marker();
        if (m2 == 0xDA) break;
        if (m2 == 0xD9) goto done;
        if (m2 >= 0xD0 && m2 <= 0xD7) continue;
        read_segment(m2);
      }
    }
  done:
    for (int c = 0; c < ncomp; ++c)
      if (!comp[c].seen) fail("corrupt JPEG: a component has no scan");
    if (!progressive) return;
    if (block_smoothing())
      fail("progressive JPEG with unrefined low-frequency coefficients "
           "(block smoothing) is not supported");
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      for (int by = 0; by < k.bh; ++by)
        for (int bx = 0; bx < k.bw; ++bx)
          idct_islow(k.block(bx, by), k.q,
                     k.plane.data() + static_cast<size_t>(by) * 8 * k.stride +
                         bx * 8,
                     k.stride);
    }
  }

  // whether libjpeg-turbo would smooth the blocks of this progressive file
  // (jdcoefct.c::smoothing_ok with its SAVED_COEFS = 10)
  bool block_smoothing() const {
    static const int kLow[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int c = 0; c < ncomp; ++c) {
      const Component& k = comp[c];
      for (int i = 0; i < 10; ++i)
        if (k.q[kLow[i]] == 0) return false;
      if (k.coef_bits[0] < 0) return false;
      for (int i = 1; i < 10; ++i)
        if (k.coef_bits[i] != 0) useful = true;
    }
    return useful;
  }

  enum class Space { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

  // jdapimin.c::default_decompress_parms
  Space color_space() const {
    if (ncomp == 1) return Space::kGray;
    if (ncomp == 3) {
      if (saw_jfif) return Space::kYCbCr;
      if (saw_adobe) return adobe_transform == 0 ? Space::kRGB : Space::kYCbCr;
      return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66
                 ? Space::kRGB
                 : Space::kYCbCr;
    }
    if (saw_adobe && adobe_transform != 0) return Space::kYCCK;
    return Space::kCMYK;
  }

  void check_supported() const {
    if (!have_frame) fail("corrupt JPEG: no frame header");
  }

  // ------------------------------------------------------- upsampling
  // one output row (hmax/vmax resolution) of component k, full width
  void upsample_row(const Component& k, int y, uint8_t* out) const {
    const int hr = hmax / k.h, vr = vmax / k.v;
    const int w = k.width;
    auto row = [&](int r) -> const uint8_t* {
      if (r < 0) r = 0;
      if (r > k.height - 1) r = k.height - 1;
      return k.plane.data() + static_cast<size_t>(r) * k.stride;
    };
    const bool fancy_h2 = hr == 2 && w > 2;
    if (hr == 2 && vr == 1 && fancy_h2) {  // h2v1_fancy_upsample
      const uint8_t* in = row(y);
      out[0] = in[0];
      out[1] = static_cast<uint8_t>((in[0] * 3 + in[1] + 2) >> 2);
      for (int c = 1; c < w - 1; ++c) {
        const int v3 = in[c] * 3;
        out[2 * c] = static_cast<uint8_t>((v3 + in[c - 1] + 1) >> 2);
        out[2 * c + 1] = static_cast<uint8_t>((v3 + in[c + 1] + 2) >> 2);
      }
      const int l = w - 1;
      out[2 * l] = static_cast<uint8_t>((in[l] * 3 + in[l - 1] + 1) >> 2);
      out[2 * l + 1] = in[l];
      return;
    }
    if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
      const int r = y >> 1;
      const bool below = y & 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(below ? r + 1 : r - 1);
      const int bias = below ? 2 : 1;
      for (int c = 0; c < w; ++c)
        out[c] = static_cast<uint8_t>((in0[c] * 3 + in1[c] + bias) >> 2);
      return;
    }
    if (hr == 2 && vr == 2 && fancy_h2) {  // h2v2_fancy_upsample
      const int r = y >> 1;
      const bool below = y & 1;
      const uint8_t* in0 = row(r);
      const uint8_t* in1 = row(below ? r + 1 : r - 1);
      int this_sum = in0[0] * 3 + in1[0];
      int next_sum = in0[1] * 3 + in1[1];
      out[0] = static_cast<uint8_t>((this_sum * 4 + 8) >> 4);
      out[1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int c = 2; c < w; ++c) {
        next_sum = in0[c] * 3 + in1[c];
        out[2 * c - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
        out[2 * c - 1] = static_cast<uint8_t>((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      out[2 * w - 2] = static_cast<uint8_t>((this_sum * 3 + last_sum + 8) >> 4);
      out[2 * w - 1] = static_cast<uint8_t>((this_sum * 4 + 7) >> 4);
      return;
    }
    // fullsize, box replication (int_upsample, h2v1/h2v2_upsample)
    const uint8_t* in = row(y / vr);
    for (int c = 0; c < w; ++c)
      for (int j = 0; j < hr; ++j) out[c * hr + j] = in[c];
  }

  void check_factors() const {
    for (int c = 0; c < ncomp; ++c) {
      if (hmax % comp[c].h || vmax % comp[c].v)
        fail("JPEG with fractional sampling ratios is not supported");
    }
  }

  // BGR rows into `out`, or gray ones (out_channels 1, one component)
  void output(uint8_t* out, int out_channels) const {
    check_factors();
    const Space space = color_space();
    const int W = width;
    const int wide = (W + 8 * hmax) * 2;  // room for an upsampled row
    std::vector<uint8_t> rows[4];
    for (int c = 0; c < ncomp; ++c) rows[c].resize(wide);
    // jdcolor.c tables
    int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
    constexpr int kScale = 16;
    constexpr int32_t kHalf = 1 << (kScale - 1);
    auto fix = [](double x) {
      return static_cast<int32_t>(x * (1 << kScale) + 0.5);
    };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (fix(1.40200) * x + kHalf) >> kScale;
      cb_b[i] = (fix(1.77200) * x + kHalf) >> kScale;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    auto clamp = [](int v) -> uint8_t {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    // OpenCV's icvCvt_CMYK2BGR_8u_C4C3R, one sample
    auto ink = [](int v, int k) {
      return static_cast<uint8_t>(k - (((255 - v) * k) >> 8));
    };
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out + static_cast<size_t>(y) * W * out_channels;
      for (int c = 0; c < ncomp; ++c) upsample_row(comp[c], y, rows[c].data());
      const uint8_t *r0 = rows[0].data(), *r1 = rows[1].data(),
                    *r2 = rows[2].data(), *r3 = rows[3].data();
      switch (space) {
        case Space::kGray:
          if (out_channels == 1) {
            std::memcpy(o, r0, W);
          } else {
            for (int x = 0; x < W; ++x)
              o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = r0[x];
          }
          break;
        case Space::kYCbCr:
          for (int x = 0; x < W; ++x) {
            const int Y = r0[x], cb = r1[x], cr = r2[x];
            o[3 * x + 2] = clamp(Y + cr_r[cr]);
            o[3 * x + 1] = clamp(Y + ((cb_g[cb] + cr_g[cr]) >> kScale));
            o[3 * x + 0] = clamp(Y + cb_b[cb]);
          }
          break;
        case Space::kRGB:
          for (int x = 0; x < W; ++x) {
            o[3 * x + 2] = r0[x];
            o[3 * x + 1] = r1[x];
            o[3 * x + 0] = r2[x];
          }
          break;
        case Space::kCMYK:
        case Space::kYCCK:
          for (int x = 0; x < W; ++x) {
            int c = r0[x], m = r1[x], yy = r2[x];
            if (space == Space::kYCCK) {  // jdcolor.c::ycck_cmyk_convert
              const int Y = r0[x], cb = r1[x], cr = r2[x];
              c = clamp(255 - (Y + cr_r[cr]));
              m = clamp(255 - (Y + ((cb_g[cb] + cr_g[cr]) >> kScale)));
              yy = clamp(255 - (Y + cb_b[cb]));
            }
            const int k = r3[x];
            o[3 * x + 2] = ink(c, k);
            o[3 * x + 1] = ink(m, k);
            o[3 * x + 0] = ink(yy, k);
          }
          break;
      }
    }
  }
};

void set_error(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

// PNG filter types (PNG spec 9.2), in place of libpng's png_read_filter_row
inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = p > a ? p - a : a - p;
  const int pb = p > b ? p - b : b - p;
  const int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// Header only: the size, component count and EXIF orientation (1 without
// one) of a JPEG. 0 on success.
int ptt_jpeg_info(const uint8_t* buf, int64_t len, int* height, int* width,
                  int* components, int* orientation, char* err,
                  int errlen) {
  try {
    Jpeg j(buf, static_cast<size_t>(len));
    j.parse_headers();
    j.check_supported();
    *height = j.height;
    *width = j.width;
    *components = j.ncomp;
    *orientation = j.orientation;
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return 1;
}

// Decode a JPEG into `out` (height * width * out_channels bytes):
// out_channels 3 gives BGR (a one-component image replicated), 1 the gray
// plane of a one-component image. 0 on success.
int ptt_jpeg_decode(const uint8_t* buf, int64_t len, uint8_t* out,
                    int height, int width, int out_channels, char* err,
                    int errlen) {
  try {
    Jpeg j(buf, static_cast<size_t>(len));
    j.decode_all();
    if (j.height != height || j.width != width)
      throw DecodeError{"JPEG size differs from the buffer's"};
    if (out_channels != 3 && !(out_channels == 1 && j.ncomp == 1))
      throw DecodeError{"out_channels must be 3, or 1 for a gray JPEG"};
    j.output(out, out_channels);
    return 0;
  } catch (const DecodeError& e) {
    set_error(err, errlen, e.msg);
  } catch (const std::exception& e) {
    set_error(err, errlen, e.what());
  }
  return 1;
}

// Undo the PNG row filters of a non-interlaced image: `raw` holds `height`
// rows of 1 + rowbytes bytes (filter type, then the filtered row), `bpp`
// is the bytes of one pixel (at least 1). Writes height * rowbytes bytes.
// 0 on success, 1 on an unknown filter type.
int ptt_png_unfilter(const uint8_t* raw, int64_t height, int64_t rowbytes,
                     int bpp, uint8_t* out) {
  const uint8_t* prev = nullptr;
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* in = raw + y * (rowbytes + 1);
    const int ft = in[0];
    ++in;
    uint8_t* o = out + y * rowbytes;
    switch (ft) {
      case 0: std::memcpy(o, in, rowbytes); break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          o[i] = static_cast<uint8_t>(in[i] + (i >= bpp ? o[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i)
          o[i] = static_cast<uint8_t>(in[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          o[i] = static_cast<uint8_t>(in[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? o[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          o[i] = static_cast<uint8_t>(in[i] + paeth(a, b, c));
        }
        break;
      default: return 1;
    }
    prev = o;
  }
  return 0;
}

}  // extern "C"
