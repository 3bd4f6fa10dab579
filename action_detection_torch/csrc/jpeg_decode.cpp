// JPEG decoder of action_detection_torch's host code, C ABI functions bound
// with ctypes (action_detection_torch/data/jpeg.py). It replaces PIL's
// Image.open(path).convert("RGB" | "L") in the frame providers, and gives
// the same bytes: it follows libjpeg-turbo's default decompression, which
// PIL runs,
//   - jidctint.c's islow IDCT (CONST_BITS 13, PASS1_BITS 2, the same
//     descaling), its output clamped to 0..255 as the x86 SIMD IDCT of
//     libjpeg-turbo does;
//   - jdsample.c's fancy upsampling (h2v1, h2v2, h1v2; the edges
//     replicated as jdmainct.c's context rows and the routines' first and
//     last columns do; h2v1 and h2v2 replicate when the downsampled width
//     is 2 or less), and replication for other integral factors and for
//     every factor of a lossless file;
//   - jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16) and its YCCK -> CMYK
//     conversion;
//   - jdhuff.c's and jdphuff.c's Huffman decoding, including what they do
//     on a marker inside the entropy data (zero bits, then grey blocks to
//     the next restart), and the standard tables of a Motion-JPEG frame
//     that has no DHT (jstdhuff.c);
//   - jdarith.c's arithmetic decoding (the QM coder of T.81 Annex D, DC
//     statistics conditioned by the DAC marker's L and U, AC by its Kx);
//   - jdcoefct.c's block smoothing of a progressive file whose scans leave
//     some of AC1-AC9 of a component not fully known (libjpeg-turbo 3.1's
//     5x5 window; decompress_smooth_data, smoothing_ok);
//   - jdlhuff.c, jddiffct.c and jdlossls.c for lossless files: predictors
//     1-7, the first-row and first-column rules, the reset at a restart,
//     the point transform shifted back on output.
// An "L" request on a colour file decodes RGB, then takes PIL's luma,
// (19595 R + 38470 G + 7471 B + 0x8000) >> 16, as Image.convert("L") does.
// A 4-component file is read as PIL reads it: libjpeg's CMYK (YCCK
// converted to it), every channel inverted ("CMYK;I"), then Pillow's
// cmyk2rgb, R = K' - (C' K' + 128 + ((C' K' + 128) >> 8)) >> 8 with
// K' = 255 - K of the inverted values.
//
// It decodes 8-bit JPEGs with 1, 3 or 4 components (grey, YCbCr or RGB,
// CMYK or YCCK): sequential Huffman (SOF0, SOF1), progressive Huffman
// (SOF2), lossless Huffman (SOF3), sequential and progressive arithmetic
// (SOF9, SOF10), interleaved or not, with restart markers, at any size.
// Baseline files stream block by block into the sample planes; the other
// DCT files fill a coefficient store, which one IDCT pass reads after EOI.
// Refused with a message naming the cause, as libjpeg or PIL refuse them:
// hierarchical files (SOF5-7, SOF13-15), lossless arithmetic (SOF11),
// a lossless file that would need a colour conversion (YCbCr or YCCK),
// precision other than 8 bits, 2 components or more than 4, a file that
// ends before its EOI marker, and anything that is not a JPEG. An
// arithmetic-coded file larger than PIL's 64 KiB read block, which PIL
// fails to read (its source manager suspends; jdarith.c cannot), decodes
// as libjpeg decodes it from a whole file.
// All state lives on the stack or in per-call buffers, so calls from
// several threads run at once (ctypes releases the GIL around each).
//
// Build (done by data/image.py at the first decode, into _build/, one
// library with image_decode.cpp, which sniffs a frame file's format):
//   g++ -O2 -std=c++17 -shared -fPIC -o libadt_image_<hash>.so
//       jpeg_decode.cpp image_decode.cpp

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
  int max_sym = 0;  // the largest symbol (a DC table's limit is checked per scan)
  uint8_t vals[256];
  int32_t maxcode[18];    // largest code of each length, -1 if none
  int32_t valoffset[18];  // vals index minus code, for each length
  uint8_t look_nbits[256];  // 8-bit lookahead: code length (0: longer)
  uint8_t look_sym[256];
};

// jdhuff.c's jpeg_make_d_derived_tbl
void build_huff(Huff& h, const uint8_t bits[17], const uint8_t* vals,
                int nsym) {
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
  h.max_sym = 0;
  for (int i = 0; i < nsym; i++) h.max_sym = std::max(h.max_sym, int(vals[i]));
  h.defined = true;
}

// The standard tables of T.81 K.3 (jstdhuff.c), for slots 0 and 1 that a
// sequential Huffman file leaves undefined (Motion-JPEG frames)
const uint8_t kStdDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1,
                                   0, 0, 0, 0, 0, 0, 0};
const uint8_t kStdDcChrBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1,
                                   1, 1, 0, 0, 0, 0, 0};
const uint8_t kStdDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kStdAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5,
                                   5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kStdAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kStdAcChrBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7,
                                   5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kStdAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

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

// ------------------------------------------------------------- arithmetic

// T.81 Table D.2, jaricom.c's jpeg_aritab: Qe, the next state after an
// MPS, the next state after an LPS, and whether an LPS swaps the MPS
struct QeState {
  uint16_t qe;
  uint8_t nmps, nlps, swap;
};
const QeState kQe[114] = {
    {0x5A1D, 1, 1, 1}, {0x2586, 2, 14, 0}, {0x1114, 3, 16, 0},
    {0x080B, 4, 18, 0}, {0x03D8, 5, 20, 0}, {0x01DA, 6, 23, 0},
    {0x00E5, 7, 25, 0}, {0x006F, 8, 28, 0}, {0x0036, 9, 30, 0},
    {0x001A, 10, 33, 0}, {0x000D, 11, 35, 0}, {0x0006, 12, 9, 0},
    {0x0003, 13, 10, 0}, {0x0001, 13, 12, 0}, {0x5A7F, 15, 15, 1},
    {0x3F25, 16, 36, 0}, {0x2CF2, 17, 38, 0}, {0x207C, 18, 39, 0},
    {0x17B9, 19, 40, 0}, {0x1182, 20, 42, 0}, {0x0CEF, 21, 43, 0},
    {0x09A1, 22, 45, 0}, {0x072F, 23, 46, 0}, {0x055C, 24, 48, 0},
    {0x0406, 25, 49, 0}, {0x0303, 26, 51, 0}, {0x0240, 27, 52, 0},
    {0x01B1, 28, 54, 0}, {0x0144, 29, 56, 0}, {0x00F5, 30, 57, 0},
    {0x00B7, 31, 59, 0}, {0x008A, 32, 60, 0}, {0x0068, 33, 62, 0},
    {0x004E, 34, 63, 0}, {0x003B, 35, 32, 0}, {0x002C, 9, 33, 0},
    {0x5AE1, 37, 37, 1}, {0x484C, 38, 64, 0}, {0x3A0D, 39, 65, 0},
    {0x2EF1, 40, 67, 0}, {0x261F, 41, 68, 0}, {0x1F33, 42, 69, 0},
    {0x19A8, 43, 70, 0}, {0x1518, 44, 72, 0}, {0x1177, 45, 73, 0},
    {0x0E74, 46, 74, 0}, {0x0BFB, 47, 75, 0}, {0x09F8, 48, 77, 0},
    {0x0861, 49, 78, 0}, {0x0706, 50, 79, 0}, {0x05CD, 51, 48, 0},
    {0x04DE, 52, 50, 0}, {0x040F, 53, 50, 0}, {0x0363, 54, 51, 0},
    {0x02D4, 55, 52, 0}, {0x025C, 56, 53, 0}, {0x01F8, 57, 54, 0},
    {0x01A4, 58, 55, 0}, {0x0160, 59, 56, 0}, {0x0125, 60, 57, 0},
    {0x00F6, 61, 58, 0}, {0x00CB, 62, 59, 0}, {0x00AB, 63, 61, 0},
    {0x008F, 32, 61, 0}, {0x5B12, 65, 65, 1}, {0x4D04, 66, 80, 0},
    {0x412C, 67, 81, 0}, {0x37D8, 68, 82, 0}, {0x2FE8, 69, 83, 0},
    {0x293C, 70, 84, 0}, {0x2379, 71, 86, 0}, {0x1EDF, 72, 87, 0},
    {0x1AA9, 73, 87, 0}, {0x174E, 74, 72, 0}, {0x1424, 75, 72, 0},
    {0x119C, 76, 74, 0}, {0x0F6B, 77, 74, 0}, {0x0D51, 78, 75, 0},
    {0x0BB6, 79, 77, 0}, {0x0A40, 48, 77, 0}, {0x5832, 81, 80, 1},
    {0x4D1C, 82, 88, 0}, {0x438E, 83, 89, 0}, {0x3BDD, 84, 90, 0},
    {0x34EE, 85, 91, 0}, {0x2EAE, 86, 92, 0}, {0x299A, 87, 93, 0},
    {0x2516, 71, 86, 0}, {0x5570, 89, 88, 1}, {0x4CA9, 90, 95, 0},
    {0x44D9, 91, 96, 0}, {0x3E22, 92, 97, 0}, {0x3824, 93, 99, 0},
    {0x32B4, 94, 99, 0}, {0x2E17, 86, 93, 0}, {0x56A8, 96, 95, 1},
    {0x4F46, 97, 101, 0}, {0x47E5, 98, 102, 0}, {0x41CF, 99, 103, 0},
    {0x3C3D, 100, 104, 0}, {0x375E, 93, 99, 0}, {0x5231, 102, 105, 0},
    {0x4C0F, 103, 106, 0}, {0x4639, 104, 107, 0}, {0x415E, 99, 103, 0},
    {0x5627, 106, 105, 1}, {0x50E7, 107, 108, 0}, {0x4B85, 103, 109, 0},
    {0x5597, 109, 110, 0}, {0x504F, 107, 111, 0}, {0x5A10, 111, 110, 1},
    {0x5522, 109, 112, 0}, {0x59EB, 111, 112, 1}, {0x5A1D, 113, 113, 0}
};  // 113: the fixed-probability state of the "fixed bin"

// jdarith.c's decoder of one scan's entropy-coded segment: C and A
// registers, the bit counter CT (-16: two bytes to read first)
struct Arith {
  const uint8_t* p;
  const uint8_t* end;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool at_marker = false;  // libjpeg's unread_marker: zeros from here on
  bool bad = false;        // libjpeg's ct == -1 after a bad code

  void reset() {
    c = a = 0;
    ct = -16;
    bad = false;
  }

  int byte() {
    if (at_marker) return 0;
    if (p >= end) fail("the file ends inside the compressed data (truncated)");
    int data = *p++;
    if (data != 0xFF) return data;
    while (p < end && *p == 0xFF) p++;  // fill bytes
    if (p >= end) fail("the file ends inside the compressed data (truncated)");
    if (*p == 0) {
      p++;
      return 0xFF;  // a stuffed zero byte
    }
    at_marker = true;  // a marker: left for the marker reader, zero data
    p--;               // at the FF before the marker code
    return 0;
  }

  // jdarith.c's arith_decode: one binary decision in statistics bin st
  int decode(uint8_t* st) {
    while (a < 0x8000) {  // renormalization and data input, D.2.6
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // the two first bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    const QeState& e = kQe[sv & 0x7F];
    const int64_t qe = e.qe;
    const int nl = e.nlps | (e.swap << 7), nm = e.nmps;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {  // conditional exchange: MPS
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

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

const int kMaxComponents = 4;

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;        // downsampled width and height (real samples)
  int wib = 0, hib = 0;      // blocks (samples when lossless) over dw, dh
  int stride = 0, rows = 0;  // the plane, padded to whole MCUs
  bool scanned = false;
  uint16_t q[64];            // its DQT table, latched at its first scan
  std::vector<uint8_t> plane;
  // the coefficient store of a progressive or arithmetic file: bw x bh
  // blocks (wib and hib rounded up to h and v, as jdcoefct.c's whole-image
  // arrays), zeroed, and the Al of the last scan of each coefficient (-1
  // before any; jdinput.c's coef_bits)
  int bw = 0, bh = 0;
  std::vector<int16_t> coef;
  int coef_bits[64];
  int16_t* block(int by, int bx) {
    return &coef[(size_t(by) * bw + bx) * 64];
  }
};

struct Image {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;  // MCUs of an interleaved scan (iMCU rows)
  int sof = -1;
  bool progressive = false, arith = false, lossless = false;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  Component comp[kMaxComponents];
};

enum Space { kGray, kRGB, kYCbCr, kCMYK, kYCCK };

// jdapimin.c's default_decompress_parms: the file's colour space from its
// markers and component ids (libjpeg-turbo 3: a lossless file with ids
// 1, 2, 3 and no marker is RGB)
Space color_space(const Image& img) {
  if (img.ncomp == 1) return kGray;
  if (img.ncomp == 4)
    return img.adobe && img.adobe_transform != 0 ? kYCCK : kCMYK;
  if (img.jfif) return kYCbCr;
  if (img.adobe) return img.adobe_transform == 0 ? kRGB : kYCbCr;
  const Component* c = img.comp;
  if (c[0].id == 'R' && c[1].id == 'G' && c[2].id == 'B') return kRGB;
  return img.lossless ? kRGB : kYCbCr;
}

// one scan's header (SOS)
struct Scan {
  int ns = 0;
  Component* cs[kMaxComponents];
  int td[kMaxComponents], ta[kMaxComponents];
  int ss = 0, se = 63, ah = 0, al = 0;
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
  bool started = false;  // the first scan has set up the planes or store
  // DAC's conditioning (jdmarker.c's get_dac; the defaults 0, 1 and 5)
  uint8_t arith_L[16], arith_U[16], arith_K[16];
  // the arithmetic statistics bins: 16 DC tables of 64, 16 AC of 256
  std::vector<uint8_t> dc_stats, ac_stats;

  Decoder(const uint8_t* d, int64_t len) : data(d), end(d + len), p(d) {
    std::memset(arith_L, 0, sizeof arith_L);
    std::memset(arith_U, 1, sizeof arith_U);
    std::memset(arith_K, 5, sizeof arith_K);
  }

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
      build_huff(tc ? ac[th] : dc[th], bits, s, nsym);
      s += nsym;
    }
  }

  // jdmarker.c's get_dac: conditioning of arithmetic tables 0-15 (DC) and
  // 16-31 (AC)
  void read_dac() {
    int len;
    const uint8_t* s = segment(&len);
    if (len & 1) fail("bad DAC length");
    for (int i = 0; i < len; i += 2) {
      int index = s[i], val = s[i + 1];
      if (index >= 32) fail("bad DAC table index " + std::to_string(index));
      if (index >= 16) {
        arith_K[index - 16] = uint8_t(val);
      } else {
        arith_L[index] = uint8_t(val & 15);
        arith_U[index] = uint8_t(val >> 4);
        if (arith_L[index] > arith_U[index])
          fail("bad DAC value " + std::to_string(val));
      }
    }
  }

  // a frame this decoder does not take, named by its SOF marker
  [[noreturn]] static void refuse_sof(int m) {
    std::string name = "SOF" + std::to_string(m - 0xC0) + ", marker " +
                       hex_marker(m);
    if (m == 0xCB)
      fail("a lossless arithmetic-coded JPEG (" + name +
           ") is not decoded: libjpeg, and so PIL, does not decode it");
    fail("a hierarchical JPEG (" + name +
         ") is not decoded: libjpeg, and so PIL, does not decode it");
  }

  void read_sof(int marker) {
    if (marker != 0xC0 && marker != 0xC1 && marker != 0xC2 &&
        marker != 0xC3 && marker != 0xC9 && marker != 0xCA)
      refuse_sof(marker);
    int len;
    const uint8_t* s = segment(&len);
    if (img.sof >= 0) fail("more than one SOF marker");
    if (len < 6) fail("bad SOF length");
    int precision = s[0];
    img.height = (s[1] << 8) | s[2];
    img.width = (s[3] << 8) | s[4];
    img.ncomp = s[5];
    img.sof = marker;
    img.progressive = marker == 0xC2 || marker == 0xCA;
    img.arith = marker == 0xC9 || marker == 0xCA;
    img.lossless = marker == 0xC3;
    std::string sof = "SOF" + std::to_string(marker - 0xC0) + ", marker " +
                      hex_marker(marker);
    if (precision != 8)
      fail(std::to_string(precision) + "-bit precision (" + sof +
           ") is not decoded: only 8-bit JPEGs are, as PIL reads only "
           "those");
    if (img.ncomp != 1 && img.ncomp != 3 && img.ncomp != 4)
      fail(std::to_string(img.ncomp) + " components (" + sof +
           ") are not decoded: only 1 (grey), 3 (colour) and 4 (CMYK or "
           "YCCK) are, as PIL reads only those");
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
    const int unit = img.lossless ? 1 : 8;  // a lossless "block" is 1 sample
    img.mcus_x = (img.width + unit * img.hmax - 1) / (unit * img.hmax);
    img.mcus_y = (img.height + unit * img.vmax - 1) / (unit * img.vmax);
    for (int i = 0; i < img.ncomp; i++) {
      Component& c = img.comp[i];
      c.dw = int((int64_t(img.width) * c.h + img.hmax - 1) / img.hmax);
      c.dh = int((int64_t(img.height) * c.v + img.vmax - 1) / img.vmax);
      c.wib = (c.dw + unit - 1) / unit;
      c.hib = (c.dh + unit - 1) / unit;
      c.stride = img.mcus_x * c.h * unit;
      c.rows = img.mcus_y * c.v * unit;
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

  // the first scan: the sample planes, the coefficient store, the
  // standard Huffman tables (jdhuff.c's jinit_huff_decoder)
  void start_frame() {
    started = true;
    if (img.lossless) {
      const Space sp = color_space(img);
      if (sp == kYCbCr || sp == kYCCK)
        fail(std::string("a lossless JPEG (SOF3) in ") +
             (sp == kYCbCr ? "YCbCr" : "YCCK") +
             " is not decoded: libjpeg makes no colour conversion of a "
             "lossless file, so PIL refuses it too");
    }
    const bool store = img.progressive || img.arith;
    for (int i = 0; i < img.ncomp; i++) {
      Component& c = img.comp[i];
      c.plane.assign(size_t(c.stride) * c.rows, 0);
      if (store) {
        c.bw = (c.wib + c.h - 1) / c.h * c.h;
        c.bh = (c.hib + c.v - 1) / c.v * c.v;
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      }
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    if (img.arith) {
      dc_stats.assign(16 * 64, 0);
      ac_stats.assign(16 * 256, 0);
    }
    if (!img.arith && !img.progressive && !img.lossless) {
      if (!dc[0].defined) build_huff(dc[0], kStdDcLumBits, kStdDcVals, 12);
      if (!ac[0].defined)
        build_huff(ac[0], kStdAcLumBits, kStdAcLumVals, 162);
      if (!dc[1].defined) build_huff(dc[1], kStdDcChrBits, kStdDcVals, 12);
      if (!ac[1].defined)
        build_huff(ac[1], kStdAcChrBits, kStdAcChrVals, 162);
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

  Scan read_sos() {
    int len;
    const uint8_t* s = segment(&len);
    if (img.sof < 0) fail("SOS before SOF");
    Scan sc;
    sc.ns = len ? s[0] : 0;
    if (sc.ns < 1 || sc.ns > img.ncomp || len < 4 + 2 * sc.ns)
      fail("bad SOS");
    int blocks_in_mcu = 0;
    const int tmax = img.arith ? 15 : 3;
    for (int i = 0; i < sc.ns; i++) {
      int id = s[1 + 2 * i];
      sc.td[i] = s[2 + 2 * i] >> 4;
      sc.ta[i] = s[2 + 2 * i] & 15;
      sc.cs[i] = nullptr;
      for (int j = 0; j < img.ncomp; j++)
        if (img.comp[j].id == id) sc.cs[i] = &img.comp[j];
      if (!sc.cs[i]) fail("SOS names an unknown component");
      if (sc.td[i] > tmax || sc.ta[i] > tmax)
        fail("SOS names a bad entropy table");
      blocks_in_mcu += sc.cs[i]->h * sc.cs[i]->v;
    }
    if (sc.ns > 1 && blocks_in_mcu > 10) fail("too many blocks in an MCU");
    const uint8_t* t = s + 1 + 2 * sc.ns;
    sc.ss = t[0];
    sc.se = t[1];
    sc.ah = t[2] >> 4;
    sc.al = t[2] & 15;
    return sc;
  }

  void need_huff(const Huff& h, bool is_dc) {
    if (!h.defined) fail("SOS names an undefined Huffman table");
    if (is_dc && h.max_sym > (img.lossless ? 16 : 15))
      fail(std::string("bad Huffman table (DC symbol above ") +
           (img.lossless ? "16" : "15") + ")");
  }

  void read_scan() {
    Scan sc = read_sos();
    if (!started) start_frame();
    for (int i = 0; i < sc.ns; i++) {
      Component& c = *sc.cs[i];
      if (!c.scanned) {  // jdinput.c's latch_quant_tables
        if (!img.lossless && !qt_defined[c.tq])
          fail("a component's DQT table is missing");
        if (!img.lossless) std::memcpy(c.q, qt[c.tq], sizeof c.q);
      }
      c.scanned = true;
    }
    if (img.lossless)
      lossless_scan(sc);
    else if (img.arith || img.progressive)
      store_scan(sc);
    else
      sequential_scan(sc);
  }

  // a sequential Huffman scan, block by block into the sample planes
  void sequential_scan(const Scan& sc) {
    const int ns = sc.ns;
    Component* const* cs = sc.cs;
    const Huff* hd[kMaxComponents];
    const Huff* ha[kMaxComponents];
    for (int i = 0; i < ns; i++) {
      need_huff(dc[sc.td[i]], true);
      need_huff(ac[sc.ta[i]], false);
      hd[i] = &dc[sc.td[i]];
      ha[i] = &ac[sc.ta[i]];
    }
    // Ss, Se, Ah/Al other than 0, 63, 0: libjpeg warns and decodes on

    Bits b{p, end};
    int pred[kMaxComponents] = {0, 0, 0, 0};
    int next_rst = 0, to_go = restart_interval;
    int64_t mx_n, my_n;
    if (ns == 1) {  // non-interleaved: one block an MCU, over the real blocks
      mx_n = cs[0]->wib;
      my_n = cs[0]->hib;
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
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
            b.insufficient = false;
            to_go = restart_interval;
          }
          to_go--;
        }
        for (int i = 0; i < ns; i++) {
          Component& c = *cs[i];
          if (ns == 1) {
            decode_block(b, *hd[i], *ha[i], &pred[i], c.q,
                         &c.plane[(my * 8) * c.stride + mx * 8], c.stride);
            continue;
          }
          for (int by = 0; by < c.v; by++)
            for (int bx = 0; bx < c.h; bx++)
              decode_block(
                  b, *hd[i], *ha[i], &pred[i], c.q,
                  &c.plane[((my * c.v + by) * 8) * c.stride +
                           (mx * c.h + bx) * 8],
                  c.stride);
        }
      }
    }
    p = b.p;  // the marker search resumes here
  }

  // The MCUs of a scan into the coefficient store, in order: restart(n)
  // at each restart marker (RSTn expected), mcu() before each MCU (false:
  // leave its blocks as they are), block(i, blk) for each block of
  // the scan's i-th component
  template <class Restart, class Mcu, class Block>
  void for_each_mcu(const Scan& sc, Restart&& restart, Mcu&& mcu,
                    Block&& block) {
    int64_t mx_n, my_n;
    if (sc.ns == 1) {  // non-interleaved: the real blocks only
      mx_n = sc.cs[0]->wib;
      my_n = sc.cs[0]->hib;
    } else {
      mx_n = img.mcus_x;
      my_n = img.mcus_y;
    }
    int next_rst = 0, to_go = restart_interval;
    for (int64_t my = 0; my < my_n; my++) {
      for (int64_t mx = 0; mx < mx_n; mx++) {
        if (restart_interval) {
          if (to_go == 0) {
            restart(next_rst);
            next_rst = (next_rst + 1) & 7;
            to_go = restart_interval;
          }
          to_go--;
        }
        if (!mcu()) continue;
        if (sc.ns == 1) {
          block(0, sc.cs[0]->block(int(my), int(mx)));
          continue;
        }
        for (int i = 0; i < sc.ns; i++) {
          Component& c = *sc.cs[i];
          for (int by = 0; by < c.v; by++)
            for (int bx = 0; bx < c.h; bx++)
              block(i, c.block(int(my) * c.v + by, int(mx) * c.h + bx));
        }
      }
    }
  }

  // jdphuff.c's and jdarith.c's checks of a progressive scan, and their
  // record of each coefficient's last Al
  void progression(const Scan& sc) {
    bool bad = false;
    if (sc.ss == 0) {
      if (sc.se != 0) bad = true;
    } else {
      if (sc.ss > sc.se || sc.se > 63) bad = true;
      if (sc.ns != 1) bad = true;  // AC scans have one component
    }
    if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
    if (sc.al > 13) bad = true;
    if (bad)
      fail("bad progressive scan (Ss " + std::to_string(sc.ss) + ", Se " +
           std::to_string(sc.se) + ", Ah " + std::to_string(sc.ah) +
           ", Al " + std::to_string(sc.al) + ")");
    for (int i = 0; i < sc.ns; i++)
      for (int k = sc.ss; k <= sc.se; k++) sc.cs[i]->coef_bits[k] = sc.al;
  }

  void store_scan(const Scan& sc) {
    if (img.progressive) progression(sc);
    if (img.arith)
      arith_scan(sc);
    else
      huffman_progressive_scan(sc);
  }

  // ---------------------------------------------- progressive Huffman

  void huffman_progressive_scan(const Scan& sc) {
    const bool dc_scan = sc.ss == 0, refine = sc.ah != 0;
    const Huff* h[kMaxComponents];
    for (int i = 0; i < sc.ns; i++) {
      if (dc_scan && !refine) need_huff(dc[sc.td[i]], true);
      if (!dc_scan) need_huff(ac[sc.ta[i]], false);
      h[i] = dc_scan ? &dc[sc.td[i]] : &ac[sc.ta[i]];
    }
    Bits b{p, end};
    int pred[kMaxComponents] = {0, 0, 0, 0};
    int eobrun = 0;
    const int al = sc.al, ss = sc.ss, se = sc.se;
    auto restart = [&](int n) {  // jdphuff.c's process_restart
      int m = b.next_marker();
      if (m != 0xD0 + n)
        fail("expected restart marker RST" + std::to_string(n) +
             ", found " + hex_marker(m));
      pred[0] = pred[1] = pred[2] = pred[3] = 0;
      eobrun = 0;
      b.insufficient = false;
    };
    // out of data: the MCUs to the next restart stay as they are, except
    // a DC refinement, which reads (zero) bits all the same
    auto mcu = [&]() { return refine && dc_scan ? true : !b.insufficient; };
    if (dc_scan && !refine) {
      for_each_mcu(sc, restart, mcu, [&](int i, int16_t* blk) {
        int s = b.decode(*h[i]);
        if (s) s = extend(b.get(s), s);
        s += pred[i];
        pred[i] = s;
        blk[0] = int16_t(unsigned(s) << al);
      });
    } else if (dc_scan) {
      for_each_mcu(sc, restart, mcu, [&](int, int16_t* blk) {
        if (b.get(1)) blk[0] = int16_t(blk[0] | (1 << al));
      });
    } else if (!refine) {
      for_each_mcu(sc, restart, mcu, [&](int, int16_t* blk) {
        ac_first(b, *h[0], ss, se, al, &eobrun, blk);
      });
    } else {
      for_each_mcu(sc, restart, mcu, [&](int, int16_t* blk) {
        ac_refine(b, *h[0], ss, se, al, &eobrun, blk);
      });
    }
    p = b.p;
  }

  // jdphuff.c's decode_mcu_AC_first
  static void ac_first(Bits& b, const Huff& h, int ss, int se, int al,
                       int* eobrun, int16_t* blk) {
    if (*eobrun > 0) {
      (*eobrun)--;
      return;
    }
    for (int k = ss; k <= se; k++) {
      int rs = b.decode(h);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] = int16_t(unsigned(extend(b.get(s), s)) << al);
      } else if (r == 15) {
        k += 15;  // ZRL: 15 zeros, and this one
      } else {  // EOBr: a run of 2^r + r more bits bands, this one included
        int run = 1 << r;
        if (r) run += b.get(r);
        *eobrun = run - 1;
        break;
      }
    }
  }

  // jdphuff.c's decode_mcu_AC_refine: correction bits for the coefficients
  // already nonzero, new coefficients of magnitude 1 << Al
  static void ac_refine(Bits& b, const Huff& h, int ss, int se, int al,
                        int* eobrun, int16_t* blk) {
    const int p1 = 1 << al, m1 = -p1;
    auto correct = [&](int16_t* c) {
      if (b.get(1) && (*c & p1) == 0)
        *c = int16_t(*c >= 0 ? *c + p1 : *c + m1);
    };
    int k = ss;
    int run = *eobrun;
    if (run == 0) {
      for (; k <= se; k++) {
        int rs = b.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {  // its size should be 1; libjpeg warns otherwise
          s = b.get(1) ? p1 : m1;
        } else if (r != 15) {
          run = 1 << r;  // EOBr
          if (r) run += b.get(r);
          break;
        }
        // over the nonzero coefficients (a correction bit each) and r
        // zero ones, to the one that becomes nonzero
        do {
          int16_t* c = blk + kNatural[k];
          if (*c != 0) {
            correct(c);
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= se);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (run > 0) {  // in an EOB run: correction bits to the band's end
      for (; k <= se; k++) {
        int16_t* c = blk + kNatural[k];
        if (*c != 0) correct(c);
      }
      run--;
    }
    *eobrun = run;
  }

  // ------------------------------------------------------- arithmetic

  void arith_scan(const Scan& sc) {
    Arith a{p, end};
    int last_dc[kMaxComponents] = {0, 0, 0, 0};
    int dc_context[kMaxComponents] = {0, 0, 0, 0};
    uint8_t fixed_bin[4] = {113, 0, 0, 0};
    const bool prog = img.progressive;
    const bool dc_first = !prog || (sc.ss == 0 && sc.ah == 0);
    const bool ac_any = !prog || sc.ss != 0;
    // jdarith.c's start_pass and process_restart: statistics and DC
    // predictions reset for the tables this scan uses
    auto reset_stats = [&]() {
      for (int i = 0; i < sc.ns; i++) {
        if (dc_first) {
          std::memset(&dc_stats[sc.td[i] * 64], 0, 64);
          last_dc[i] = 0;
          dc_context[i] = 0;
        }
        if (ac_any) std::memset(&ac_stats[sc.ta[i] * 256], 0, 256);
      }
      a.reset();
    };
    reset_stats();
    auto restart = [&](int n) {
      a.at_marker = false;  // a.p is at or before the marker
      int m = find_marker(a.p, end);
      if (m != 0xD0 + n)
        fail("expected restart marker RST" + std::to_string(n) +
             ", found " + hex_marker(m));
      reset_stats();
    };
    auto mcu = [&]() { return !a.bad; };
    const int al = sc.al, ss = sc.ss, se = sc.se;

    // F.2.4.1 (Figures F.19, F.21-F.24): a DC difference
    auto dc_diff = [&](int i) -> int {
      const int tbl = sc.td[i];
      uint8_t* st = &dc_stats[tbl * 64 + dc_context[i]];
      if (a.decode(st) == 0) {
        dc_context[i] = 0;
        return 0;
      }
      int sign = a.decode(st + 1);
      st += 2 + sign;
      int m = a.decode(st);
      if (m != 0) {
        st = &dc_stats[tbl * 64 + 20];  // X1
        while (a.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            a.bad = true;  // magnitude overflow: libjpeg warns
            return 0;
          }
          st += 1;
        }
      }
      if (m < int((1L << arith_L[tbl]) >> 1))
        dc_context[i] = 0;  // a zero difference category
      else if (m > int((1L << arith_U[tbl]) >> 1))
        dc_context[i] = 12 + sign * 4;  // large
      else
        dc_context[i] = 4 + sign * 4;  // small
      int v = m;
      st += 14;
      while (m >>= 1)
        if (a.decode(st)) v |= m;
      v += 1;
      return sign ? -v : v;
    };
    // an AC value's sign and magnitude (Figures F.21-F.24), st at S0 + 3k
    auto ac_value = [&](uint8_t* base, uint8_t* st, int k, int tbl) -> int {
      int sign = a.decode(fixed_bin);
      st += 2;
      int m = a.decode(st);
      if (m != 0) {
        if (a.decode(st)) {
          m <<= 1;
          st = base + (k <= arith_K[tbl] ? 189 : 217);
          while (a.decode(st)) {
            if ((m <<= 1) == 0x8000) {
              a.bad = true;
              return 0;
            }
            st += 1;
          }
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (a.decode(st)) v |= m;
      v += 1;
      return sign ? -v : v;
    };
    // Figure F.20: AC coefficients k0..k1 (jdarith.c's decode_mcu's AC
    // part and decode_mcu_AC_first)
    auto ac_first = [&](int i, int16_t* blk, int k0, int k1, int shift) {
      const int tbl = sc.ta[i];
      uint8_t* base = &ac_stats[tbl * 256];
      for (int k = k0; k <= k1; k++) {
        uint8_t* st = base + 3 * (k - 1);
        if (a.decode(st)) break;  // EOB
        while (a.decode(st + 1) == 0) {
          st += 3;
          if (++k > k1) {
            a.bad = true;  // spectral overflow
            return;
          }
        }
        int v = ac_value(base, st, k, tbl);
        if (a.bad) return;
        blk[kNatural[k]] = int16_t(unsigned(v) << shift);
      }
    };

    if (!prog) {  // decode_mcu
      for_each_mcu(sc, restart, mcu, [&](int i, int16_t* blk) {
        if (a.bad) return;
        int v = dc_diff(i);
        if (a.bad) return;
        last_dc[i] = (last_dc[i] + v) & 0xFFFF;
        blk[0] = int16_t(last_dc[i]);
        ac_first(i, blk, 1, 63, 0);
      });
    } else if (sc.ss == 0 && sc.ah == 0) {  // decode_mcu_DC_first
      for_each_mcu(sc, restart, mcu, [&](int i, int16_t* blk) {
        if (a.bad) return;
        int v = dc_diff(i);
        if (a.bad) return;
        last_dc[i] += v;
        blk[0] = int16_t(unsigned(last_dc[i]) << al);
      });
    } else if (sc.ss == 0) {  // decode_mcu_DC_refine
      auto all = [&]() { return true; };
      for_each_mcu(sc, restart, all, [&](int, int16_t* blk) {
        if (a.decode(fixed_bin)) blk[0] = int16_t(blk[0] | (1 << al));
      });
    } else if (sc.ah == 0) {  // decode_mcu_AC_first
      for_each_mcu(sc, restart, mcu, [&](int, int16_t* blk) {
        ac_first(0, blk, ss, se, al);
      });
    } else {  // decode_mcu_AC_refine
      const int p1 = 1 << al, m1 = -p1;
      uint8_t* base = &ac_stats[sc.ta[0] * 256];
      for_each_mcu(sc, restart, mcu, [&](int, int16_t* blk) {
        int kex;  // the previous stage's end of block
        for (kex = se; kex > 0; kex--)
          if (blk[kNatural[kex]]) break;
        for (int k = ss; k <= se; k++) {
          uint8_t* st = base + 3 * (k - 1);
          if (k > kex && a.decode(st)) break;  // EOB
          for (;;) {
            int16_t* c = blk + kNatural[k];
            if (*c) {  // a coefficient nonzero before: its correction bit
              if (a.decode(st + 2)) *c = int16_t(*c < 0 ? *c + m1 : *c + p1);
              break;
            }
            if (a.decode(st + 1)) {  // newly nonzero
              *c = int16_t(a.decode(fixed_bin) ? m1 : p1);
              break;
            }
            st += 3;
            if (++k > se) {
              a.bad = true;
              return;
            }
          }
        }
      });
    }
    p = a.p;
  }

  // --------------------------------------------------------- lossless

  // jdlhuff.c, jddiffct.c and jdlossls.c: the differences of an iMCU row
  // are decoded, then each of its rows undifferenced with predictor Ss
  // (the first row after the start or a restart by the first-row rule)
  // and shifted left by Pt (Al)
  void lossless_scan(const Scan& sc) {
    const int ns = sc.ns, pred_sel = sc.ss, pt = sc.al;
    if (pred_sel < 1 || pred_sel > 7 || sc.se != 0 || sc.ah != 0 ||
        pt > 7)
      fail("bad lossless scan (predictor " + std::to_string(pred_sel) +
           ", Pt " + std::to_string(pt) + ")");
    const Huff* h[kMaxComponents];
    for (int i = 0; i < ns; i++) {
      need_huff(dc[sc.td[i]], true);
      h[i] = &dc[sc.td[i]];
    }
    const int mcus_per_row = ns > 1 ? img.mcus_x : sc.cs[0]->wib;
    if (restart_interval % mcus_per_row)
      fail("a lossless restart interval of " +
           std::to_string(restart_interval) +
           " MCUs is not a multiple of the " + std::to_string(mcus_per_row) +
           " MCUs of a row (libjpeg refuses it)");
    const int rows_per_restart = restart_interval / mcus_per_row;
    const int T = img.mcus_y;  // iMCU rows
    // per component: v rows of differences and of undifferenced samples
    std::vector<int> diff[kMaxComponents], undiff[kMaxComponents];
    int width[kMaxComponents];
    for (int i = 0; i < ns; i++) {
      const Component& c = *sc.cs[i];
      width[i] = ns > 1 ? img.mcus_x * c.h : c.wib;
      diff[i].assign(size_t(c.v) * width[i], 0);
      undiff[i].assign(size_t(c.v) * width[i], 0);
    }
    bool first_row[kMaxComponents] = {true, true, true, true};
    const int initial = 1 << (8 - pt - 1);
    Bits b{p, end};
    int next_rst = 0, rows_to_go = rows_per_restart;
    for (int r = 0; r < T; r++) {
      const int mcu_rows =
          ns > 1 ? 1
                 : (r < T - 1 ? sc.cs[0]->v
                              : (sc.cs[0]->hib % sc.cs[0]->v
                                     ? sc.cs[0]->hib % sc.cs[0]->v
                                     : sc.cs[0]->v));
      for (int yoff = 0; yoff < mcu_rows; yoff++) {
        if (restart_interval) {
          if (rows_to_go == 0) {
            int m = b.next_marker();
            if (m != 0xD0 + next_rst)
              fail("expected restart marker RST" +
                   std::to_string(next_rst) + ", found " + hex_marker(m));
            next_rst = (next_rst + 1) & 7;
            b.insufficient = false;
            for (bool& f : first_row) f = true;
            rows_to_go = rows_per_restart;
          }
        }
        if (b.insufficient) {  // out of data: zeros, predictors reset
          for (int i = 0; i < ns; i++) {
            const int rows = ns > 1 ? sc.cs[i]->v : 1;
            for (int y = 0; y < rows; y++)
              std::fill_n(&diff[i][size_t(ns > 1 ? y : yoff) * width[i]],
                          width[i], 0);
          }
          for (bool& f : first_row) f = true;
        } else {
          for (int mx = 0; mx < mcus_per_row; mx++) {
            for (int i = 0; i < ns; i++) {
              const Component& c = *sc.cs[i];
              const int hh = ns > 1 ? c.h : 1, vv = ns > 1 ? c.v : 1;
              for (int by = 0; by < vv; by++)
                for (int bx = 0; bx < hh; bx++) {
                  int s = b.decode(*h[i]);
                  if (s == 16) {
                    s = 32768;
                  } else if (s) {
                    s = extend(b.get(s), s);
                  }
                  const int row = ns > 1 ? by : yoff;
                  diff[i][size_t(row) * width[i] + mx * hh + bx] = s;
                }
            }
          }
        }
        if (restart_interval) rows_to_go--;
      }
      for (int i = 0; i < ns; i++) {
        Component& c = *sc.cs[i];
        const int rows = r < T - 1 ? c.v : (c.hib % c.v ? c.hib % c.v : c.v);
        const int w = c.wib;
        for (int row = 0, prev = c.v - 1; row < rows; prev = row, row++) {
          const int* d = &diff[i][size_t(row) * width[i]];
          int* u = &undiff[i][size_t(row) * width[i]];
          const int* up = &undiff[i][size_t(prev) * width[i]];
          if (first_row[i]) {  // 2^(P-Pt-1), then Ra
            int ra = (d[0] + initial) & 0xFFFF;
            u[0] = ra;
            for (int x = 1; x < w; x++) u[x] = ra = (d[x] + ra) & 0xFFFF;
            first_row[i] = false;
          } else {  // Rb in the first column, then the predictor
            int rb = up[0];
            int ra = (d[0] + rb) & 0xFFFF;
            u[0] = ra;
            for (int x = 1; x < w; x++) {
              const int rc = rb;
              rb = up[x];
              int px;
              switch (pred_sel) {
                case 1: px = ra; break;
                case 2: px = rb; break;
                case 3: px = rc; break;
                case 4: px = ra + rb - rc; break;
                case 5: px = ra + ((rb - rc) >> 1); break;
                case 6: px = rb + ((ra - rc) >> 1); break;
                default: px = (ra + rb) >> 1; break;
              }
              u[x] = ra = (d[x] + px) & 0xFFFF;
            }
          }
          uint8_t* o = &c.plane[size_t(r * c.v + row) * c.stride];
          for (int x = 0; x < w; x++) o[x] = uint8_t(u[x] << pt);
        }
      }
    }
    p = b.p;
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
        case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC5: case 0xC6:
        case 0xC7: case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE:
        case 0xCF:
          read_sof(m);
          break;
        case 0xC4:
          read_dht();
          break;
        case 0xCC:
          read_dac();
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
    if (img.progressive || img.arith) output_store();
  }

  // ------------------------------------------- the store's output pass

  // jdcoefct.c's smoothing_ok: a progressive file, DC known and the
  // quantizers read nonzero for every component, and some of AC1-AC9 of
  // some component not fully known
  bool smoothing_ok() const {
    if (!img.progressive) return false;
    bool useful = false;
    for (int i = 0; i < img.ncomp; i++) {
      const Component& c = img.comp[i];
      const uint16_t* q = c.q;
      if (!q[0] || !q[1] || !q[8] || !q[16] || !q[9] || !q[2] || !q[3] ||
          !q[10] || !q[17] || !q[24])
        return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k <= 9; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }

  // One IDCT pass over each component's real blocks, through
  // decompress_smooth_data's estimates where smoothing is on
  void output_store() {
    const bool smooth = smoothing_ok();
    for (int i = 0; i < img.ncomp; i++) {
      Component& c = img.comp[i];
      if (smooth) {
        smooth_component(c);
        continue;
      }
      for (int by = 0; by < c.hib; by++)
        for (int bx = 0; bx < c.wib; bx++)
          idct_islow(c.block(by, bx), c.q,
                     &c.plane[size_t(by) * 8 * c.stride + bx * 8], c.stride);
    }
  }

  // libjpeg-turbo 3.1's decompress_smooth_data for one component: each
  // block's zero coefficients among AC1-AC9 that are not fully known are
  // estimated from the DC values of the 5x5 blocks around it (with DC
  // itself where no AC is known at all), clamped below 1 << Al
  void smooth_component(Component& c) {
    const int* bits = c.coef_bits;
    bool change_dc = true;
    for (int k = 1; k <= 9; k++)
      if (bits[k] != -1) change_dc = false;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                  Q11 = c.q[9], Q02 = c.q[2], Q03 = c.q[3], Q12 = c.q[10],
                  Q21 = c.q[17], Q30 = c.q[24];
    const int T = img.mcus_y;  // iMCU rows
    const int last_col = c.wib - 1;
    for (int r = 0; r < T; r++) {
      // block rows of this iMCU row: v, or what is left in the last
      int block_rows = c.v;
      if (r == T - 1) {
        block_rows = c.hib % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int image_block_rows = block_rows * T;
      for (int b = 0; b < block_rows; b++) {
        const int image_block_row = r * block_rows + b;
        const int row = r * c.v + b;
        const int prev = image_block_row > 0 ? row - 1 : row;
        const int prev2 = image_block_row > 1 ? row - 2 : prev;
        const int next = image_block_row < image_block_rows - 1 ? row + 1
                                                                : row;
        const int next2 = image_block_row < image_block_rows - 2 ? row + 2
                                                                 : next;
        const int rows5[5] = {prev2, prev, row, next, next2};
        for (int bx = 0; bx <= last_col; bx++) {
          // DC01..DC25: rows prev2..next2, columns bx-2..bx+2 (clamped)
          int DC[26];
          for (int i = 0; i < 5; i++)
            for (int j = 0; j < 5; j++) {
              const int col = std::min(std::max(bx + j - 2, 0), last_col);
              DC[1 + 5 * i + j] = c.block(rows5[i], col)[0];
            }
          int16_t ws[64];
          std::memcpy(ws, c.block(row, bx), sizeof ws);
          auto estimate = [](int64_t num, int64_t q, int al) {
            int pred;
            if (num >= 0) {
              pred = int(((q << 7) + num) / (q << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
            } else {
              pred = int(((q << 7) - num) / (q << 8));
              if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
              pred = -pred;
            }
            return int16_t(pred);
          };
          int al;
          if ((al = bits[1]) != 0 && ws[1] == 0) {  // AC01
            int64_t num = Q00 * (change_dc
                ? (-DC[1] - DC[2] + DC[4] + DC[5] - 3 * DC[6] + 13 * DC[7] -
                   13 * DC[9] + 3 * DC[10] - 3 * DC[11] + 38 * DC[12] -
                   38 * DC[14] + 3 * DC[15] - 3 * DC[16] + 13 * DC[17] -
                   13 * DC[19] + 3 * DC[20] - DC[21] - DC[22] + DC[24] +
                   DC[25])
                : (-7 * DC[11] + 50 * DC[12] - 50 * DC[14] + 7 * DC[15]));
            ws[1] = estimate(num, Q01, al);
          }
          if ((al = bits[2]) != 0 && ws[8] == 0) {  // AC10
            int64_t num = Q00 * (change_dc
                ? (-DC[1] - 3 * DC[2] - 3 * DC[3] - 3 * DC[4] - DC[5] -
                   DC[6] + 13 * DC[7] + 38 * DC[8] + 13 * DC[9] - DC[10] +
                   DC[16] - 13 * DC[17] - 38 * DC[18] - 13 * DC[19] +
                   DC[20] + DC[21] + 3 * DC[22] + 3 * DC[23] + 3 * DC[24] +
                   DC[25])
                : (-7 * DC[3] + 50 * DC[8] - 50 * DC[18] + 7 * DC[23]));
            ws[8] = estimate(num, Q10, al);
          }
          if ((al = bits[3]) != 0 && ws[16] == 0) {  // AC20
            int64_t num = Q00 * (change_dc
                ? (DC[3] + 2 * DC[7] + 7 * DC[8] + 2 * DC[9] - 5 * DC[12] -
                   14 * DC[13] - 5 * DC[14] + 2 * DC[17] + 7 * DC[18] +
                   2 * DC[19] + DC[23])
                : (-DC[3] + 13 * DC[8] - 24 * DC[13] + 13 * DC[18] -
                   DC[23]));
            ws[16] = estimate(num, Q20, al);
          }
          if ((al = bits[4]) != 0 && ws[9] == 0) {  // AC11
            int64_t num = Q00 * (change_dc
                ? (-DC[1] + DC[5] + 9 * DC[7] - 9 * DC[9] - 9 * DC[17] +
                   9 * DC[19] + DC[21] - DC[25])
                : (DC[10] + DC[16] - 10 * DC[17] + 10 * DC[19] - DC[2] -
                   DC[20] + DC[22] - DC[24] + DC[4] - DC[6] + 10 * DC[7] -
                   10 * DC[9]));
            ws[9] = estimate(num, Q11, al);
          }
          if ((al = bits[5]) != 0 && ws[2] == 0) {  // AC02
            int64_t num = Q00 * (change_dc
                ? (2 * DC[7] - 5 * DC[8] + 2 * DC[9] + DC[11] + 7 * DC[12] -
                   14 * DC[13] + 7 * DC[14] + DC[15] + 2 * DC[17] -
                   5 * DC[18] + 2 * DC[19])
                : (-DC[11] + 13 * DC[12] - 24 * DC[13] + 13 * DC[14] -
                   DC[15]));
            ws[2] = estimate(num, Q02, al);
          }
          if (change_dc) {
            if ((al = bits[6]) != 0 && ws[3] == 0) {  // AC03
              int64_t num = Q00 * (DC[7] - DC[9] + 2 * DC[12] - 2 * DC[14] +
                                   DC[17] - DC[19]);
              ws[3] = estimate(num, Q03, al);
            }
            if ((al = bits[7]) != 0 && ws[10] == 0) {  // AC12
              int64_t num = Q00 * (DC[7] - 3 * DC[8] + DC[9] - DC[17] +
                                   3 * DC[18] - DC[19]);
              ws[10] = estimate(num, Q12, al);
            }
            if ((al = bits[8]) != 0 && ws[17] == 0) {  // AC21
              int64_t num = Q00 * (DC[7] - DC[9] - 3 * DC[12] + 3 * DC[14] +
                                   DC[17] - DC[19]);
              ws[17] = estimate(num, Q21, al);
            }
            if ((al = bits[9]) != 0 && ws[24] == 0) {  // AC30
              int64_t num = Q00 * (DC[7] + 2 * DC[8] + DC[9] - DC[17] -
                                   2 * DC[18] - DC[19]);
              ws[24] = estimate(num, Q30, al);
            }
            // DC itself, a Gaussian-like average of the 25 (bits[0] >= 0)
            int64_t num = Q00 *
                (-2 * DC[1] - 6 * DC[2] - 8 * DC[3] - 6 * DC[4] - 2 * DC[5] -
                 6 * DC[6] + 6 * DC[7] + 42 * DC[8] + 6 * DC[9] - 6 * DC[10] -
                 8 * DC[11] + 42 * DC[12] + 152 * DC[13] + 42 * DC[14] -
                 8 * DC[15] - 6 * DC[16] + 6 * DC[17] + 42 * DC[18] +
                 6 * DC[19] - 6 * DC[20] - 2 * DC[21] - 6 * DC[22] -
                 8 * DC[23] - 6 * DC[24] - 2 * DC[25]);
            ws[0] = estimate(num, Q00, 0);
          }
          idct_islow(ws, c.q, &c.plane[size_t(row) * 8 * c.stride + bx * 8],
                     c.stride);
        }
      }
    }
  }
};

// ------------------------------------------------- upsampling and colour

// The full-size samples of component c at image row y: columns [0, W),
// written to out, which holds at least 2 * dw + 1 bytes. pad holds dw + 2
// ints: the row (or column sums) with its first and last value repeated
// on each side, the edge rule of jdsample.c's fancy routines. A lossless
// file is upsampled by replication only (libjpeg's min_DCT_scaled_size 1
// turns fancy upsampling off).
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
  const bool fancy = !img.lossless;
  if (fancy && fh == 2 && fv == 1 && dw > 2) {  // h2v1_fancy_upsample
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
  if (fancy && fh == 1 && fv == 2) {  // h1v2_fancy_upsample
    const int bias = (y & 1) ? 2 : 1;
    for (int x = 0; x < W; x++)
      out[x] = uint8_t((r0[x] * 3 + r1[x] + bias) >> 2);
    return;
  }
  if (fancy && fh == 2 && fv == 2 && dw > 2) {  // h2v2_fancy_upsample
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

// jdcolor.c's ycc_rgb_convert, as (r, g, b)
inline void ycc_rgb(int yy, int cb, int cr, int* r, int* g, int* b) {
  *r = clamp255(yy + kColor.cr_r[cr]);
  *g = clamp255(yy + ((kColor.cb_g[cb] + kColor.cr_g[cr]) >> 16));
  *b = clamp255(yy + kColor.cb_b[cb]);
}

template <int CHANNELS>
inline void put_pixel(uint8_t* o, int x, int r, int g, int b) {
  if (CHANNELS == 3) {
    o[3 * x] = uint8_t(r);
    o[3 * x + 1] = uint8_t(g);
    o[3 * x + 2] = uint8_t(b);
  } else {
    o[x] = pil_luma(r, g, b);
  }
}

// jdcolor.c's ycc_rgb_convert (or the RGB copy), then PIL's luma for 1
// channel
template <bool YCC, int CHANNELS>
void convert_row(const uint8_t* const* c, int W, uint8_t* o) {
  for (int x = 0; x < W; x++) {
    int r, g, b;
    if (YCC) {
      ycc_rgb(c[0][x], c[1][x], c[2][x], &r, &g, &b);
    } else {
      r = c[0][x];
      g = c[1][x];
      b = c[2][x];
    }
    put_pixel<CHANNELS>(o, x, r, g, b);
  }
}

// Pillow's MULDIV255
inline int muldiv255(int a, int b) {
  int t = a * b + 128;
  return ((t >> 8) + t) >> 8;
}

// A 4-component row as PIL reads it: libjpeg's CMYK (jdcolor.c's
// ycck_cmyk_convert for YCCK: 255 - each of the YCbCr -> RGB values, K
// as is), inverted ("CMYK;I"), then Pillow's cmyk2rgb. The inverse of
// 255 - clamp(x) is clamp(x), so YCCK's inverted C, M, Y are the YCbCr ->
// RGB values themselves; the inverted K' gives 255 - K' = the file's K.
template <bool YCCK, int CHANNELS>
void convert_row4(const uint8_t* const* c, int W, uint8_t* o) {
  for (int x = 0; x < W; x++) {
    int ci, mi, yi;  // the inverted C, M, Y
    if (YCCK) {
      ycc_rgb(c[0][x], c[1][x], c[2][x], &ci, &mi, &yi);
    } else {
      ci = 255 - c[0][x];
      mi = 255 - c[1][x];
      yi = 255 - c[2][x];
    }
    const int nk = c[3][x];
    put_pixel<CHANNELS>(o, x, nk - muldiv255(ci, nk), nk - muldiv255(mi, nk),
                        nk - muldiv255(yi, nk));
  }
}

void write_output(const Image& img, int channels, uint8_t* out) {
  const int W = img.width, H = img.height;
  const size_t row = size_t(2) * W + 16;  // room for 2 * dw + 1 samples
  std::vector<uint8_t> rows(row * img.ncomp);
  std::vector<int> pad(W + 2);
  const uint8_t* planes[kMaxComponents];
  for (int c = 0; c < img.ncomp; c++) planes[c] = &rows[c * row];
  void (*convert)(const uint8_t* const*, int, uint8_t*) = nullptr;
  switch (color_space(img)) {
    case kGray: break;
    case kYCbCr:
      convert = channels == 3 ? convert_row<true, 3> : convert_row<true, 1>;
      break;
    case kRGB:
      convert = channels == 3 ? convert_row<false, 3> : convert_row<false, 1>;
      break;
    case kYCCK:
      convert = channels == 3 ? convert_row4<true, 3> : convert_row4<true, 1>;
      break;
    case kCMYK:
      convert =
          channels == 3 ? convert_row4<false, 3> : convert_row4<false, 1>;
      break;
  }
  for (int y = 0; y < H; y++) {
    for (int c = 0; c < img.ncomp; c++)
      upsample_row(img, img.comp[c], y, &rows[c * row], pad.data());
    uint8_t* o = out + size_t(y) * W * channels;
    if (convert) {
      convert(planes, W, o);
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
    if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
      d.read_sof(m);
      *img = d.img;
      return;
    }
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

// Decode the JPEG in data[0, len) into out, (height, width, channels)
// uint8 C-contiguous; channels 3 is PIL's convert("RGB"), 1 its
// convert("L"). info receives height, width and the file's component
// count. Returns 0; 1 with a message in err for a file this decoder
// refuses; 3, before decoding, where capacity (out's bytes) is not
// height * width * channels: call again with such a buffer. The image
// decoder (image_decode.cpp) hands its JPEG files to this function.
int adt_jpeg_decode_buffer(const uint8_t* data, int64_t len, int channels,
                           uint8_t* out, int64_t capacity, int64_t* info,
                           char* err, int64_t errlen) {
  try {
    if (channels != 1 && channels != 3) fail("channels must be 1 or 3");
    Image head;
    read_header(data, len, &head);
    info[0] = head.height;
    info[1] = head.width;
    info[2] = head.ncomp;
    if (capacity != int64_t(head.height) * head.width * channels) return 3;
    Decoder d(data, len);
    d.parse();
    write_output(d.img, channels, out);
    return 0;
  } catch (const std::exception& e) {  // JpegError, std::bad_alloc
    return report(e, err, errlen);
  }
}

// adt_jpeg_decode_buffer on the bytes of the file at path; info[3]
// receives errno. Returns 2 where the file cannot be read (info[3] =
// errno), else what adt_jpeg_decode_buffer returns.
int adt_jpeg_decode_file(const char* path, int channels, uint8_t* out,
                         int64_t capacity, int64_t* info, char* err,
                         int64_t errlen) {
  std::vector<uint8_t> data;
  try {
    errno = 0;
    if (!read_file(path, &data)) {
      info[3] = errno;
      return 2;
    }
  } catch (const std::exception& e) {  // std::bad_alloc
    return report(e, err, errlen);
  }
  return adt_jpeg_decode_buffer(data.data(), int64_t(data.size()), channels,
                                out, capacity, info, err, errlen);
}

}  // extern "C"
