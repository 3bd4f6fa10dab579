// Baseline JPEG decoder of action_detection_torch's host code, C ABI
// functions bound with ctypes (action_detection_torch/data/jpeg.py). It
// replaces PIL's Image.open(path).convert("RGB" | "L") in the frame
// providers, and gives the same bytes: it follows libjpeg's default
// decompression, which PIL runs,
//   - jidctint.c's islow IDCT (CONST_BITS 13, PASS1_BITS 2, the same
//     descaling), its output clamped to 0..255 as the x86 SIMD IDCT of
//     libjpeg-turbo does;
//   - jdsample.c's fancy upsampling (h2v1, h2v2, h1v2; the edges
//     replicated as jdmainct.c's context rows and the routines' first and
//     last columns do; h2v1 and h2v2 replicate when the downsampled width
//     is 2 or less), and replication for other integral factors;
//   - jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16);
//   - jdhuff.c's decoding, including what it does on a marker inside the
//     entropy data (zero bits, then grey blocks to the next restart).
// An "L" request on a colour file decodes RGB, then takes PIL's luma,
// (19595 R + 38470 G + 7471 B + 0x8000) >> 16, as Image.convert("L") does.
//
// It decodes sequential Huffman JPEGs (SOF0, SOF1) of 8-bit precision with
// 1 or 3 components, interleaved or not, with restart markers, at any
// size. Progressive, lossless, hierarchical and arithmetic-coded files,
// 12-bit precision, other component counts (CMYK, YCCK) and a file that
// ends before its EOI marker are refused with a message naming the cause.
// All state lives on the stack or in per-call buffers, so calls from
// several threads run at once (ctypes releases the GIL around each).
//
// Build (done by data/jpeg.py at the first decode, into _build/):
//   g++ -O2 -std=c++17 -shared -fPIC -o libadt_jpeg_<hash>.so jpeg_decode.cpp

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct JpegError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw JpegError(msg); }

std::string hex_marker(int m) {
  char buf[16];
  std::snprintf(buf, sizeof buf, "0xFF%02X", m);
  return buf;
}

// zigzag index -> natural (row-major) index; 16 extra entries absorb a
// corrupt run length past 63, as libjpeg's jpeg_natural_order does
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman

struct Huff {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // vals index minus code, for each length
  uint8_t look_nbits[256];  // 8-bit lookahead: code length (0: longer)
  uint8_t look_sym[256];
};

// jdhuff.c's jpeg_make_d_derived_tbl
void build_huff(Huff& h, const uint8_t bits[17], const uint8_t* vals,
                int nsym, bool dc) {
  int huffsize[257];
  int32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (int32_t(1) << si)) fail("bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (bits[l]) {
      h.valoffset[l] = p - huffcode[p];
      p += bits[l];
      h.maxcode[l] = huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoffset[17] = 0;
  h.maxcode[17] = 0xFFFFF;  // ends the slow decode loop at length 17
  std::memset(h.look_nbits, 0, sizeof h.look_nbits);
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 1; i <= bits[l]; i++, p++) {
      int look = huffcode[p] << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; ctr--, look++) {
        h.look_nbits[look] = uint8_t(l);
        h.look_sym[look] = vals[p];
      }
    }
  }
  std::memcpy(h.vals, vals, nsym);
  if (dc)
    for (int i = 0; i < nsym; i++)
      if (vals[i] > 15) fail("bad Huffman table (DC symbol above 15)");
  h.defined = true;
}

// The entropy-coded bits of one scan. Bytes are taken up to the next
// marker and no further; past it (or past the end of the file) there are
// no more bits.
struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;  // the low n bits are unread
  int n = 0;
  bool at_marker = false;
  bool at_eof = false;
  bool insufficient = false;  // jdhuff.c's insufficient_data

  void fill(int need) {
    while (n <= 56 && !at_marker && !at_eof) {
      if (p >= end) {
        at_eof = true;
        break;
      }
      uint32_t c = *p;
      if (c == 0xFF) {
        const uint8_t* q = p + 1;
        while (q < end && *q == 0xFF) q++;  // fill bytes before a marker
        if (q >= end) {
          at_eof = true;
          break;
        }
        if (*q != 0) {
          at_marker = true;
          p = q - 1;  // at the FF before the marker code
          break;
        }
        p = q + 1;  // FF 00 stands for an FF data byte
      } else {
        p++;
      }
      buf = (buf << 8) | c;
      n += 8;
    }
    if (n < need) {
      // PIL raises on a truncated file: so does this. At a marker libjpeg
      // warns and goes on with zero bits; so does this.
      if (at_eof) fail("the file ends inside the compressed data (truncated)");
      insufficient = true;
      buf <<= (57 - n);
      n = 57;
    }
  }

  int get(int k) {
    if (n < k) fill(k);
    n -= k;
    return int((buf >> n) & ((uint64_t(1) << k) - 1));
  }

  // jdhuff.c's HUFF_DECODE and jpeg_huff_decode
  int decode(const Huff& h) {
    int l = 1;
    if (n < 8) fill(0);
    if (n >= 8) {
      int look = int((buf >> (n - 8)) & 0xFF);
      int nb = h.look_nbits[look];
      if (nb) {
        n -= nb;
        return h.look_sym[look];
      }
      l = 9;
    }
    int32_t code = get(l);
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      l++;
    }
    if (l > 16) return 0;  // a bad code: libjpeg warns and takes 0
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }

  // drop what is left of the bits; the next marker's code, p past it
  int next_marker();
};

// The code of the next marker at or after p, skipping any other bytes and
// fill bytes; p is left just past it.
int find_marker(const uint8_t*& p, const uint8_t* end) {
  for (;;) {
    while (p < end && *p != 0xFF) p++;
    while (p < end && *p == 0xFF) p++;
    if (p >= end) fail("the file ends before its EOI marker (truncated)");
    if (*p != 0) return *p++;
  }
}

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

int Bits::next_marker() {
  buf = 0;
  n = 0;
  at_marker = at_eof = false;
  return find_marker(p, end);
}

// ------------------------------------------------------------------- IDCT

const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

inline uint8_t clamp_sample(int64_t x) {  // + CENTERJSAMPLE, saturated
  x += 128;
  return uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// jidctint.c's jpeg_idct_islow: dequantize, 8x8 inverse DCT, write the
// block at out (row stride `stride`)
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = (int(in[0]) * qt[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int(in[16]) * qt[16], z3 = int(in[48]) * qt[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int(in[0]) * qt[0];
    z3 = int(in[32]) * qt[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int(in[56]) * qt[56];
    tmp1 = int(in[40]) * qt[40];
    tmp2 = int(in[24]) * qt[24];
    tmp3 = int(in[8]) * qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = int(descale(tmp10 + tmp3, sh));
    w[56] = int(descale(tmp10 - tmp3, sh));
    w[8] = int(descale(tmp11 + tmp2, sh));
    w[48] = int(descale(tmp11 - tmp2, sh));
    w[16] = int(descale(tmp12 + tmp1, sh));
    w[40] = int(descale(tmp12 - tmp1, sh));
    w[24] = int(descale(tmp13 + tmp0, sh));
    w[32] = int(descale(tmp13 - tmp0, sh));
  }
  const int sh = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = clamp_sample(descale(w[0], PASS1_BITS + 3));
      for (int i = 0; i < 8; i++) o[i] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    o[0] = clamp_sample(descale(tmp10 + tmp3, sh));
    o[7] = clamp_sample(descale(tmp10 - tmp3, sh));
    o[1] = clamp_sample(descale(tmp11 + tmp2, sh));
    o[6] = clamp_sample(descale(tmp11 - tmp2, sh));
    o[2] = clamp_sample(descale(tmp12 + tmp1, sh));
    o[5] = clamp_sample(descale(tmp12 - tmp1, sh));
    o[3] = clamp_sample(descale(tmp13 + tmp0, sh));
    o[4] = clamp_sample(descale(tmp13 - tmp0, sh));
  }
}

// ------------------------------------------------------------ the decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled width and height (real samples)
  int stride = 0, rows = 0;  // the plane, padded to whole MCUs
  bool scanned = false;
  std::vector<uint8_t> plane;
};

struct Image {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;
  int sof = -1;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  Component comp[3];
};

struct Decoder {
  const uint8_t* data;
  const uint8_t* end;
  const uint8_t* p;
  Image img;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;

  Decoder(const uint8_t* d, int64_t len) : data(d), end(d + len), p(d) {}

  int u8() {
    if (p >= end) fail("the file ends inside a marker segment (truncated)");
    return *p++;
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  int next_marker() { return find_marker(p, end); }

  // the payload of a marker segment: [start, start + len)
  const uint8_t* segment(int* len) {
    int n = u16();
    if (n < 2) fail("bad marker segment length");
    if (end - p < n - 2) fail("the file ends inside a marker segment "
                              "(truncated)");
    const uint8_t* s = p;
    p += n - 2;
    *len = n - 2;
    return s;
  }

  void read_dqt() {
    int len;
    const uint8_t* s = segment(&len);
    const uint8_t* e = s + len;
    while (s < e) {
      int pq = *s >> 4, tq = *s & 15;
      s++;
      if (tq > 3) fail("bad DQT table index");
      int bytes = pq ? 128 : 64;
      if (e - s < bytes) fail("bad DQT length");
      for (int i = 0; i < 64; i++) {
        int v = pq ? (s[2 * i] << 8) | s[2 * i + 1] : s[i];
        qt[tq][kNatural[i]] = uint16_t(v);
      }
      s += bytes;
      qt_defined[tq] = true;
    }
  }

  void read_dht() {
    int len;
    const uint8_t* s = segment(&len);
    const uint8_t* e = s + len;
    while (s < e) {
      if (e - s < 17) fail("bad DHT length");
      int tc = *s >> 4, th = *s & 15;
      s++;
      if (tc > 1 || th > 3) fail("bad DHT table index");
      uint8_t bits[17] = {0};
      int nsym = 0;
      for (int l = 1; l <= 16; l++) nsym += bits[l] = *s++;
      if (nsym > 256 || e - s < nsym) fail("bad DHT length");
      build_huff(tc ? ac[th] : dc[th], bits, s, nsym, tc == 0);
      s += nsym;
    }
  }

  void read_sof(int marker) {
    int len;
    const uint8_t* s = segment(&len);
    if (img.sof >= 0) fail("more than one SOF marker");
    if (len < 6) fail("bad SOF length");
    int precision = s[0];
    img.height = (s[1] << 8) | s[2];
    img.width = (s[3] << 8) | s[4];
    img.ncomp = s[5];
    img.sof = marker;
    std::string sof = "SOF" + std::to_string(marker - 0xC0) + ", marker " +
                      hex_marker(marker);
    if (precision != 8)
      fail(std::to_string(precision) + "-bit precision (" + sof +
           ") is not decoded: only 8-bit JPEGs are");
    if (img.ncomp != 1 && img.ncomp != 3)
      fail(std::to_string(img.ncomp) + " components (" + sof +
           "; CMYK or YCCK when 4) are not decoded: only grayscale and "
           "3-component colour JPEGs are");
    if (img.height == 0)
      fail("a height given by a DNL marker (" + sof + ") is not decoded");
    if (img.width == 0) fail("zero image width");
    if (len < 6 + 3 * img.ncomp) fail("bad SOF length");
    for (int i = 0; i < img.ncomp; i++) {
      Component& c = img.comp[i];
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad SOF component parameters");
      img.hmax = std::max(img.hmax, c.h);
      img.vmax = std::max(img.vmax, c.v);
    }
    img.mcus_x = (img.width + 8 * img.hmax - 1) / (8 * img.hmax);
    img.mcus_y = (img.height + 8 * img.vmax - 1) / (8 * img.vmax);
    for (int i = 0; i < img.ncomp; i++) {
      Component& c = img.comp[i];
      c.dw = int((int64_t(img.width) * c.h + img.hmax - 1) / img.hmax);
      c.dh = int((int64_t(img.height) * c.v + img.vmax - 1) / img.vmax);
      c.stride = img.mcus_x * c.h * 8;
      c.rows = img.mcus_y * c.v * 8;
      c.plane.assign(size_t(c.stride) * c.rows, 0);
    }
  }

  void read_app(int marker) {
    int len;
    const uint8_t* s = segment(&len);
    // jdmarker.c: examine_app0 and examine_app14
    if (marker == 0xE0 && len >= 14 && !std::memcmp(s, "JFIF\0", 5))
      img.jfif = true;
    if (marker == 0xEE && len >= 12 && !std::memcmp(s, "Adobe", 5)) {
      img.adobe = true;
      img.adobe_transform = s[11];
    }
  }

  void decode_block(Bits& b, const Huff& hdc, const Huff& hac, int* pred,
                    const uint16_t* q, uint8_t* out, int stride) {
    int16_t blk[64];
    std::memset(blk, 0, sizeof blk);
    if (!b.insufficient) {  // out of data: the block stays zero (grey)
      int s = b.decode(hdc);
      if (s) s = extend(b.get(s), s);
      s += *pred;
      *pred = s;
      blk[0] = int16_t(s);
      for (int k = 1; k < 64; k++) {
        int rs = b.decode(hac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(extend(b.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    idct_islow(blk, q, out, stride);
  }

  void read_scan() {
    int len;
    const uint8_t* s = segment(&len);
    if (img.sof < 0) fail("SOS before SOF");
    int ns = len ? s[0] : 0;
    if (ns < 1 || ns > img.ncomp || len < 4 + 2 * ns) fail("bad SOS");
    Component* cs[3];
    const Huff* hd[3];
    const Huff* ha[3];
    int blocks_in_mcu = 0;
    for (int i = 0; i < ns; i++) {
      int id = s[1 + 2 * i], td = s[2 + 2 * i] >> 4, ta = s[2 + 2 * i] & 15;
      cs[i] = nullptr;
      for (int j = 0; j < img.ncomp; j++)
        if (img.comp[j].id == id) cs[i] = &img.comp[j];
      if (!cs[i]) fail("SOS names an unknown component");
      if (td > 3 || ta > 3 || !dc[td].defined || !ac[ta].defined)
        fail("SOS names an undefined Huffman table");
      if (!qt_defined[cs[i]->tq]) fail("a component's DQT table is missing");
      hd[i] = &dc[td];
      ha[i] = &ac[ta];
      cs[i]->scanned = true;
      blocks_in_mcu += cs[i]->h * cs[i]->v;
    }
    if (ns > 1 && blocks_in_mcu > 10) fail("too many blocks in an MCU");
    // Ss, Se, Ah/Al other than 0, 63, 0: libjpeg warns and decodes on

    Bits b{p, end};
    int pred[3] = {0, 0, 0};
    int next_rst = 0, to_go = restart_interval;
    int64_t mx_n, my_n;
    if (ns == 1) {  // non-interleaved: one block an MCU, over the real blocks
      mx_n = (cs[0]->dw + 7) / 8;
      my_n = (cs[0]->dh + 7) / 8;
    } else {
      mx_n = img.mcus_x;
      my_n = img.mcus_y;
    }
    for (int64_t my = 0; my < my_n; my++) {
      for (int64_t mx = 0; mx < mx_n; mx++) {
        if (restart_interval) {
          if (to_go == 0) {
            int m = b.next_marker();
            if (m != 0xD0 + next_rst)
              fail("expected restart marker RST" + std::to_string(next_rst) +
                   ", found " + hex_marker(m));
            next_rst = (next_rst + 1) & 7;
            pred[0] = pred[1] = pred[2] = 0;
            b.insufficient = false;
            to_go = restart_interval;
          }
          to_go--;
        }
        for (int i = 0; i < ns; i++) {
          Component& c = *cs[i];
          const uint16_t* q = qt[c.tq];
          if (ns == 1) {
            decode_block(b, *hd[i], *ha[i], &pred[i], q,
                         &c.plane[(my * 8) * c.stride + mx * 8], c.stride);
            continue;
          }
          for (int by = 0; by < c.v; by++)
            for (int bx = 0; bx < c.h; bx++)
              decode_block(
                  b, *hd[i], *ha[i], &pred[i], q,
                  &c.plane[((my * c.v + by) * 8) * c.stride +
                           (mx * c.h + bx) * 8],
                  c.stride);
        }
      }
    }
    p = b.p;  // the marker search resumes here
  }

  // a frame this decoder does not take, named by its SOF (or DAC) marker
  [[noreturn]] static void refuse_sof(int m) {
    std::string name = (m == 0xCC ? "DAC" : "SOF" + std::to_string(m - 0xC0)) +
                       ", marker " + hex_marker(m);
    if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE)
      fail("progressive JPEG (" + name +
           ") is not decoded: only sequential (baseline) JPEGs are");
    fail("a lossless, hierarchical or arithmetic-coded JPEG (" + name +
         ") is not decoded: only sequential Huffman JPEGs are");
  }

  void parse() {
    if (end - p < 2 || p[0] != 0xFF || p[1] != 0xD8)
      fail("not a JPEG file (no SOI marker)");
    p += 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;  // a stray RSTn: libjpeg skips it
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_sof(m);
          break;
        case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9:
        case 0xCA: case 0xCB: case 0xCC: case 0xCD: case 0xCE: case 0xCF:
          refuse_sof(m);
        case 0xC4:
          read_dht();
          break;
        case 0xDB:
          read_dqt();
          break;
        case 0xDD: {
          int len;
          const uint8_t* s = segment(&len);
          if (len < 2) fail("bad DRI length");
          restart_interval = (s[0] << 8) | s[1];
          break;
        }
        case 0xDA:
          read_scan();
          break;
        case 0xFE:  // COM
        case 0xDC:  // DNL after the first scan: the height is known
          int len;
          segment(&len);
          break;
        default:
          if (m >= 0xE0 && m <= 0xEF) {
            read_app(m);
            break;
          }
          fail("unexpected marker " + hex_marker(m));
      }
    }
    if (img.sof < 0) fail("no SOF marker before EOI");
    for (int i = 0; i < img.ncomp; i++)
      if (!img.comp[i].scanned) fail("a component has no scan");
  }
};

// ------------------------------------------------- upsampling and colour

// The full-size samples of component c at image row y: columns [0, W),
// written to out, which holds at least 2 * dw + 1 bytes. pad holds dw + 2
// ints: the row (or column sums) with its first and last value repeated
// on each side, the edge rule of jdsample.c's fancy routines.
void upsample_row(const Image& img, const Component& c, int y, uint8_t* out,
                  int* pad) {
  const int W = img.width;
  const int fh = img.hmax / c.h, fv = img.vmax / c.v;
  const uint8_t* P = c.plane.data();
  const int S = c.stride;
  const int dw = c.dw, dh = c.dh;
  if (fh == 1 && fv == 1) {
    std::memcpy(out, P + size_t(y) * S, W);
    return;
  }
  if (fh == 2 && fv == 1 && dw > 2) {  // h2v1_fancy_upsample
    const uint8_t* r = P + size_t(y) * S;
    for (int j = 0; j < dw; j++) pad[j + 1] = r[j];
    pad[0] = pad[1];
    pad[dw + 1] = pad[dw];
    for (int j = 0; j < dw; j++) {
      int v3 = pad[j + 1] * 3;
      out[2 * j] = uint8_t((v3 + pad[j] + 1) >> 2);
      out[2 * j + 1] = uint8_t((v3 + pad[j + 2] + 2) >> 2);
    }
    return;
  }
  // the nearer row and the next nearer one (above for an even output row,
  // below for an odd one; jdmainct.c repeats the first and last rows)
  const int i = y / fv;
  const int nb = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
  const uint8_t* r0 = P + size_t(i) * S;
  const uint8_t* r1 = P + size_t(nb) * S;
  if (fh == 1 && fv == 2) {  // h1v2_fancy_upsample
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < W; x++)
      out[x] = uint8_t((r0[x] * 3 + r1[x] + bias) >> 2);
    return;
  }
  if (fh == 2 && fv == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int j = 0; j < dw; j++) pad[j + 1] = r0[j] * 3 + r1[j];
    pad[0] = pad[1];
    pad[dw + 1] = pad[dw];
    for (int j = 0; j < dw; j++) {
      int t3 = pad[j + 1] * 3;
      out[2 * j] = uint8_t((t3 + pad[j] + 8) >> 4);
      out[2 * j + 1] = uint8_t((t3 + pad[j + 2] + 7) >> 4);
    }
    return;
  }
  if (img.hmax % c.h || img.vmax % c.v)
    fail("fractional sampling factors are not decoded");
  for (int x = 0; x < W; x++) out[x] = r0[x / fh];  // int_upsample
}

struct ColorTables {
  int cr_r[256], cb_b[256], cr_g[256], cb_g[256];
  ColorTables() {  // jdcolor.c's build_ycc_rgb_table
    const int ONE_HALF = 1 << 15;
    auto fix = [](double x) { return int(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (fix(1.40200) * x + ONE_HALF) >> 16;
      cb_b[i] = (fix(1.77200) * x + ONE_HALF) >> 16;
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const ColorTables kColor;  // built once, at load; read-only after

inline uint8_t clamp255(int v) {
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

inline uint8_t pil_luma(int r, int g, int b) {
  return uint8_t((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16);
}

// jdcolor.c's ycc_rgb_convert (or the RGB copy), then PIL's luma for 1
// channel
template <bool YCC, int CHANNELS>
void convert_row(const uint8_t* c0, const uint8_t* c1, const uint8_t* c2,
                 int W, uint8_t* o) {
  for (int x = 0; x < W; x++) {
    int r, g, b;
    if (YCC) {
      const int yy = c0[x], cb = c1[x], cr = c2[x];
      r = clamp255(yy + kColor.cr_r[cr]);
      g = clamp255(yy + ((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
      b = clamp255(yy + kColor.cb_b[cb]);
    } else {
      r = c0[x];
      g = c1[x];
      b = c2[x];
    }
    if (CHANNELS == 3) {
      o[3 * x] = uint8_t(r);
      o[3 * x + 1] = uint8_t(g);
      o[3 * x + 2] = uint8_t(b);
    } else {
      o[x] = pil_luma(r, g, b);
    }
  }
}

void write_output(const Image& img, int channels, uint8_t* out) {
  const int W = img.width, H = img.height;
  const size_t row = size_t(2) * W + 16;  // room for 2 * dw + 1 samples
  std::vector<uint8_t> rows(row * img.ncomp);
  std::vector<int> pad(W + 2);
  // libjpeg's jpeg_color_space from the markers and component ids
  bool ycc = true;
  if (img.ncomp == 3 && !img.jfif && img.adobe)
    ycc = img.adobe_transform != 0;
  else if (img.ncomp == 3 && !img.jfif && !img.adobe)
    ycc = !(img.comp[0].id == 'R' && img.comp[1].id == 'G' &&
            img.comp[2].id == 'B');
  auto convert = img.ncomp == 1 ? nullptr
      : ycc ? (channels == 3 ? convert_row<true, 3> : convert_row<true, 1>)
            : (channels == 3 ? convert_row<false, 3> : convert_row<false, 1>);
  for (int y = 0; y < H; y++) {
    for (int c = 0; c < img.ncomp; c++)
      upsample_row(img, img.comp[c], y, &rows[c * row], pad.data());
    uint8_t* o = out + size_t(y) * W * channels;
    if (convert) {
      convert(&rows[0], &rows[row], &rows[2 * row], W, o);
    } else if (channels == 1) {
      std::memcpy(o, rows.data(), W);
    } else {
      for (int x = 0; x < W; x++)
        o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = rows[x];
    }
  }
}

// the frame header alone: the first SOFn's size and component count, or a
// refusal of its kind
void read_header(const uint8_t* data, int64_t len, Image* img) {
  Decoder d(data, len);
  if (len < 2 || data[0] != 0xFF || data[1] != 0xD8)
    fail("not a JPEG file (no SOI marker)");
  d.p += 2;
  for (;;) {
    int m = d.next_marker();
    if (m == 0xC0 || m == 0xC1) {
      d.read_sof(m);
      *img = d.img;
      return;
    }
    if (m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8)
      Decoder::refuse_sof(m);
    if (m == 0xD9 || m == 0xDA) fail("no SOF marker before the first scan");
    if (m >= 0xD0 && m <= 0xD7) continue;
    int n;
    d.segment(&n);
  }
}

int report(const std::exception& e, char* err, int64_t errlen) {
  if (errlen > 0) {
    std::strncpy(err, e.what(), size_t(errlen - 1));
    err[errlen - 1] = 0;
  }
  return 1;
}

// The bytes of the file at path; false with errno set where it cannot be
// read.
bool read_file(const char* path, std::vector<uint8_t>* data) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  uint8_t chunk[1 << 16];
  size_t n;
  while ((n = std::fread(chunk, 1, sizeof chunk, f)) > 0)
    data->insert(data->end(), chunk, chunk + n);
  const bool ok = !std::ferror(f);
  const int saved = errno;
  std::fclose(f);
  errno = saved;
  return ok;
}

}  // namespace

extern "C" {

// Decode the JPEG file at path into out, (height, width, channels) uint8
// C-contiguous; channels 3 is PIL's convert("RGB"), 1 its convert("L").
// info receives height, width, the file's component count and errno.
// Returns 0; 1 with a message in err for a file this decoder refuses; 2
// where the file cannot be read (info[3] = errno); 3, before decoding,
// where capacity (out's bytes) is not height * width * channels: call
// again with such a buffer.
int adt_jpeg_decode_file(const char* path, int channels, uint8_t* out,
                         int64_t capacity, int64_t* info, char* err,
                         int64_t errlen) {
  try {
    if (channels != 1 && channels != 3) fail("channels must be 1 or 3");
    std::vector<uint8_t> data;
    errno = 0;
    if (!read_file(path, &data)) {
      info[3] = errno;
      return 2;
    }
    Image head;
    read_header(data.data(), int64_t(data.size()), &head);
    info[0] = head.height;
    info[1] = head.width;
    info[2] = head.ncomp;
    if (capacity != int64_t(head.height) * head.width * channels) return 3;
    Decoder d(data.data(), int64_t(data.size()));
    d.parse();
    write_output(d.img, channels, out);
    return 0;
  } catch (const std::exception& e) {  // JpegError, std::bad_alloc
    return report(e, err, errlen);
  }
}

}  // extern "C"
