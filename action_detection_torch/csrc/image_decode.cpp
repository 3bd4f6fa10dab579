// Frame-file decoder of action_detection_torch's host code, C ABI functions
// bound with ctypes (action_detection_torch/data/image.py). It replaces
// PIL's Image.open(path).convert("RGB" | "L") in the frame providers for
// every format the port reads, and gives the same bytes (Pillow 12.1):
//   - it reads the file once and sniffs its first bytes as PIL's plugins
//     do: FF D8 FF is a JPEG (handed to jpeg_decode.cpp), 89 "PNG" 0D 0A
//     1A 0A a PNG, "BM" a BMP, a DIB header size (12, 40, 52, 56, 64, 108
//     or 124) a headerless DIB, "P1" to "P6" a PNM;
//   - PNG: an inflate of its own (RFC 1950/1951: stored, fixed and dynamic
//     Huffman blocks, zlib's rules for code sets, the Adler-32 checked),
//     colour types 0, 2, 3, 4 and 6 at every bit depth they allow, the
//     five row filters, Adam7 interlace, PLTE (a missing entry is black,
//     as PIL's palette pads), tRNS (alpha is dropped: PIL's RGBA -> RGB
//     and LA -> L take no compositing), every chunk's CRC checked, IDAT
//     split over chunks (the first run of IDATs, as PIL reads it);
//     PngImagePlugin's modes: 1-bit grey is mode "1" (0/255), 2- and 4-bit
//     grey are scaled (x85, x17), 16-bit grey is "I;16", which convert
//     clips at 255, 16-bit colour takes the high byte ("RGB;16B",
//     "RGBA;16B", "LA;16B");
//   - BMP and DIB as BmpImagePlugin reads them: the OS/2 core header and
//     the 40/52/56/64/108/124-byte info headers, 1, 4, 8, 16, 24 and 32
//     bits, BI_RGB, BI_RLE8, BI_RLE4 (BmpRleDecoder's reading, including
//     its clipped runs, its absolute runs of an odd RLE4 count, which drop
//     the last pixel, its padding at the word boundary of the file
//     position and its delta escape, which reads four bytes and moves by
//     the last two), BI_BITFIELDS with the masks PIL supports, bottom-up
//     and top-down rows, the grey-palette rule (a palette equal to 0..n-1,
//     or to 0 and 255 for two entries, is read as L or 1), 16-bit pixels
//     expanded as the BGR;15 and BGR;16 unpackers do (v * 255 / 31, v *
//     255 / 63);
//   - PNM as PpmImagePlugin reads it: P1-P6, its header tokens (a "#"
//     comment runs to the line's end inside a token too), a maxval other
//     than 255 scaled as Python's round(v / maxval * out_max) (half to
//     even, in doubles), mode "I" for grey with maxval > 255 (P5 at 65535
//     raw, else scaled to 65535), 16-bit RGB scaled to 255, P1's "1" and
//     P4's set bits black;
//   - then PIL's convert: grey to RGB replicates, colour to L is PIL's
//     integer luma (19595 R + 38470 G + 7471 B + 0x8000) >> 16 (a palette
//     image's too: PIL takes the palette entries' luma), "I;16" and "I"
//     clip to 0..255.
// Refused with a message naming the cause (the binding adds the path):
// every other format PIL sniffs, by name (GIF, TIFF, WebP, AVIF, JPEG
// 2000, QOI, TGA, ICO, ...), with the formats the port decodes; a
// truncated file, a bad CRC or Adler-32, a corrupt deflate stream, what
// PIL refuses (unsupported BMP depths, compressions and bitfields, PNG
// colour types and depths that do not exist), and the few files PIL
// misreads (a grey-palette BMP whose samples PIL unpacks at the wrong
// width). All state lives on the stack or in per-call buffers, so calls
// from several threads run at once (ctypes releases the GIL around each).
//
// Build (done by data/image.py at the first decode, into _build/, one
// library with jpeg_decode.cpp):
//   g++ -O2 -std=c++17 -shared -fPIC -o libadt_image_<hash>.so
//       jpeg_decode.cpp image_decode.cpp

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

extern "C" int adt_jpeg_decode_buffer(const uint8_t* data, int64_t len,
                                      int channels, uint8_t* out,
                                      int64_t capacity, int64_t* info,
                                      char* err, int64_t errlen);

namespace {

struct ImageError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw ImageError(msg); }

enum Format { kUnknown = -1, kJpeg = 0, kPng = 1, kBmp = 2, kPnm = 3 };

// PIL refuses an image of more pixels (2 * Image.MAX_IMAGE_PIXELS)
constexpr int64_t kMaxPixels = 2 * 89478485;

// A decoded image before PIL's convert: 1 (grey) or 3 (RGB) samples a
// pixel, row-major.
struct Pixels {
  int width = 0, height = 0, channels = 0;
  std::vector<uint8_t> data;
  void allocate() { data.assign(size_t(width) * height * channels, 0); }
};

inline uint32_t be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | p[3];
}
inline uint32_t le32(const uint8_t* p) {
  return uint32_t(p[0]) | (uint32_t(p[1]) << 8) | (uint32_t(p[2]) << 16) |
         (uint32_t(p[3]) << 24);
}
inline uint16_t le16(const uint8_t* p) { return uint16_t(p[0] | (p[1] << 8)); }

// ------------------------------------------------------------- checksums

struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t n = 0; n < 256; n++) {
      uint32_t c = n;
      for (int k = 0; k < 8; k++) c = c & 1 ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[n] = c;
    }
  }
};
const Crc32Table kCrc;

uint32_t crc32(const uint8_t* p, size_t n, uint32_t crc = 0) {
  crc = ~crc;
  for (size_t i = 0; i < n; i++) crc = kCrc.t[(crc ^ p[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = n < 5552 ? n : 5552;  // no overflow before the modulo
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

// ---------------------------------------------------------------- inflate

// LSB-first bits of a byte string; reads past the end give zero bits and
// are caught by overran().
struct Bits {
  const uint8_t* data;
  size_t len, pos = 0;
  uint64_t buf = 0;
  int cnt = 0;
  Bits(const uint8_t* d, size_t n) : data(d), len(n) {}
  void refill() {
    while (cnt <= 56) {
      uint64_t b = pos < len ? data[pos] : 0;
      pos++;
      buf |= b << cnt;
      cnt += 8;
    }
  }
  uint32_t peek(int n) {
    if (cnt < n) refill();
    return uint32_t(buf & ((uint64_t(1) << n) - 1));
  }
  void drop(int n) {
    buf >>= n;
    cnt -= n;
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    drop(n);
    return v;
  }
  // bytes consumed, whole (after align())
  size_t consumed() const { return pos - size_t(cnt / 8); }
  bool overran() const { return int64_t(pos) * 8 - cnt > int64_t(len) * 8; }
  void align() { drop(cnt & 7); }
  void check() const {
    if (overran()) fail("the compressed image data ends early (truncated)");
  }
};

constexpr int kFast = 10;  // bits of the direct lookup table

// A canonical Huffman code (RFC 1951 3.2.2): a kFast-bit lookup of the
// short codes, puff's count/symbol walk for the longer ones.
struct Huffman {
  uint16_t fast[1 << kFast];  // (symbol << 4) | length; 0: a longer code
  int16_t count[16];
  int16_t symbol[320];

  // zlib's inflate_table rules: an over-subscribed set is an error, an
  // incomplete one too unless it is a single code of length 1 (allowed
  // for the literal/length and distance codes, not for the code-length
  // code); no code at all is allowed (a distance code a block never uses)
  void build(const uint8_t* lengths, int n, bool code_lengths) {
    std::memset(count, 0, sizeof count);
    for (int i = 0; i < n; i++) count[lengths[i]]++;
    count[0] = 0;
    int max = 15;
    while (max > 0 && count[max] == 0) max--;
    int left = 1;
    for (int len = 1; len <= 15; len++) {
      left <<= 1;
      left -= count[len];
      if (left < 0) fail("corrupt deflate stream (over-subscribed code)");
    }
    if (left > 0 && max > 0 && (code_lengths || max != 1))
      fail("corrupt deflate stream (incomplete code)");
    int16_t offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; len++) offs[len + 1] = offs[len] + count[len];
    for (int i = 0; i < n; i++)
      if (lengths[i]) symbol[offs[lengths[i]]++] = int16_t(i);
    std::memset(fast, 0, sizeof fast);
    int code = 0, k = 0;
    for (int len = 1; len <= 15; len++) {
      for (int j = 0; j < count[len]; j++, k++, code++) {
        if (len > kFast) continue;
        int rev = 0;  // the code's bits, first bit lowest
        for (int b = 0; b < len; b++) rev |= ((code >> b) & 1) << (len - 1 - b);
        const uint16_t e = uint16_t((symbol[k] << 4) | len);
        for (int f = rev; f < (1 << kFast); f += 1 << len) fast[f] = e;
      }
      code <<= 1;
    }
  }

  int decode(Bits& b) const {
    const uint16_t e = fast[b.peek(kFast)];
    if (e) {
      b.drop(e & 15);
      return e >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; len++) {
      code |= int(b.get(1));
      const int c = count[len];
      if (code - c < first) return symbol[index + (code - first)];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    fail("corrupt deflate stream (invalid code)");
  }
};

const int kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,
                          15, 17, 19, 23, 27, 31, 35, 43, 51,  59,
                          67, 83, 99, 115, 131, 163, 195, 227, 258};
const int kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                           2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
const int kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,
                           17,   25,   33,   49,   65,   97,    129,   193,
                           257,  385,  513,  769,  1025, 1537,  2049,  3073,
                           4097, 6145, 8193, 12289, 16385, 24577};
const int kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                            6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

[[noreturn]] void too_long() {
  fail("the compressed image data holds more than the image (corrupt)");
}

void inflate_codes(Bits& b, const Huffman& lit, const Huffman& dist,
                   std::vector<uint8_t>* out, size_t limit) {
  for (;;) {
    const int sym = lit.decode(b);
    if (sym < 256) {
      out->push_back(uint8_t(sym));
      if (out->size() > limit) too_long();
      continue;
    }
    if (sym == 256) return;
    const int li = sym - 257;
    if (li >= 29) fail("corrupt deflate stream (invalid length code)");
    const int len = kLenBase[li] + int(b.get(kLenExtra[li]));
    const int ds = dist.decode(b);
    if (ds >= 30) fail("corrupt deflate stream (invalid distance code)");
    const size_t d = size_t(kDistBase[ds]) + b.get(kDistExtra[ds]);
    if (d > out->size())
      fail("corrupt deflate stream (distance too far back)");
    if (out->size() + len > limit) too_long();
    b.check();
    const size_t from = out->size() - d;
    for (int i = 0; i < len; i++) {
      const uint8_t v = (*out)[from + i];
      out->push_back(v);
    }
  }
}

// RFC 1950 around RFC 1951: the zlib header, the blocks, the Adler-32 of
// what they give. `expect` is the image's size; a stream that gives more
// than 64 KiB beyond it is refused (PIL reads the rows it needs and stops,
// so this bounds the memory a corrupt stream can take).
std::vector<uint8_t> zlib_inflate(const uint8_t* data, size_t len,
                                  size_t expect) {
  const size_t limit = expect + (size_t(1) << 16);
  if (len < 2) fail("the compressed image data ends early (truncated)");
  const int cmf = data[0], flg = data[1];
  if ((cmf * 256 + flg) % 31 || (cmf & 15) != 8 || (cmf >> 4) > 7)
    fail("corrupt zlib stream (bad header)");
  if (flg & 0x20) fail("corrupt zlib stream (a preset dictionary)");
  Bits b(data + 2, len - 2);
  std::vector<uint8_t> out;
  out.reserve(expect);
  Huffman lit, dist;
  static const uint8_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                     11, 4,  12, 3, 13, 2, 14, 1, 15};
  int final_block;
  do {
    final_block = int(b.get(1));
    const int type = int(b.get(2));
    if (type == 0) {  // stored
      b.align();
      const uint32_t n = b.get(16), nn = b.get(16);
      if ((n ^ 0xFFFF) != nn)
        fail("corrupt deflate stream (stored block length)");
      if (out.size() + n > limit) too_long();
      for (uint32_t i = 0; i < n; i++) out.push_back(uint8_t(b.get(8)));
    } else if (type == 1) {  // fixed Huffman codes
      uint8_t l[288];
      for (int i = 0; i < 288; i++)
        l[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
      lit.build(l, 288, false);
      uint8_t d[32];  // 30 and 31 complete the code; they are invalid
      std::memset(d, 5, sizeof d);
      dist.build(d, 32, false);
      inflate_codes(b, lit, dist, &out, limit);
    } else if (type == 2) {  // dynamic Huffman codes
      const int nlen = int(b.get(5)) + 257, ndist = int(b.get(5)) + 1;
      const int ncode = int(b.get(4)) + 4;
      if (nlen > 286 || ndist > 30)
        fail("corrupt deflate stream (too many length or distance codes)");
      uint8_t cl[19] = {0};
      for (int i = 0; i < ncode; i++) cl[kOrder[i]] = uint8_t(b.get(3));
      Huffman lencode;
      lencode.build(cl, 19, true);
      uint8_t lengths[316];
      int i = 0;
      while (i < nlen + ndist) {
        int sym = lencode.decode(b);
        if (sym < 16) {
          lengths[i++] = uint8_t(sym);
          continue;
        }
        int rep, val = 0;
        if (sym == 16) {
          if (i == 0) fail("corrupt deflate stream (repeat with no length)");
          val = lengths[i - 1];
          rep = 3 + int(b.get(2));
        } else if (sym == 17) {
          rep = 3 + int(b.get(3));
        } else {
          rep = 11 + int(b.get(7));
        }
        if (i + rep > nlen + ndist)
          fail("corrupt deflate stream (too many code lengths)");
        while (rep--) lengths[i++] = uint8_t(val);
      }
      if (lengths[256] == 0)
        fail("corrupt deflate stream (no end-of-block code)");
      lit.build(lengths, nlen, false);
      dist.build(lengths + nlen, ndist, false);
      inflate_codes(b, lit, dist, &out, limit);
    } else {
      fail("corrupt deflate stream (block type 3)");
    }
    b.check();
  } while (!final_block);
  b.align();
  b.check();
  const size_t at = 2 + b.consumed();
  if (len < at + 4) fail("the compressed image data ends early (truncated)");
  if (be32(data + at) != adler32(out.data(), out.size()))
    fail("corrupt zlib stream (Adler-32 mismatch)");
  return out;
}

// -------------------------------------------------------------------- PNG

const uint8_t kPngMagic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};

struct PngHeader {
  uint32_t width = 0, height = 0;
  int depth = 0, ctype = 0, interlace = 0;
  int samples() const {  // samples a pixel
    return ctype == 2 ? 3 : ctype == 4 ? 2 : ctype == 6 ? 4 : 1;
  }
  int out_channels() const { return ctype == 0 || ctype == 4 ? 1 : 3; }
};

struct Png {
  PngHeader h;
  std::vector<uint8_t> idat;
  uint8_t palette[256][3];
  int palette_entries = 0;
};

bool is_chunk_name(const uint8_t* p) {
  for (int i = 0; i < 4; i++) {
    const int c = p[i];
    if (!((c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') ||
          (c >= '0' && c <= '9') || c == '_'))
      return false;
  }
  return true;
}

// Walk the chunks (each CRC-checked) up to IEND; with header_only, stop
// after IHDR.
void png_chunks(const uint8_t* data, size_t len, Png* png, bool header_only) {
  size_t p = 8;
  bool seen_ihdr = false, idat_run = false, idat_done = false;
  for (;;) {
    if (len - p < 8) fail("the PNG file ends before IEND (truncated)");
    const uint32_t n = be32(data + p);
    const uint8_t* name = data + p + 4;
    if (!is_chunk_name(name)) fail("broken PNG file (bad chunk name)");
    const std::string cid(reinterpret_cast<const char*>(name), 4);
    if (n > len - p - 8 || len - p - 8 - n < 4)
      fail("the PNG file ends inside chunk " + cid + " (truncated)");
    const uint8_t* body = data + p + 8;
    if (be32(body + n) != crc32(name, n + 4))
      fail("broken PNG file (bad CRC in " + cid + ")");
    p += 12 + size_t(n);
    if (!seen_ihdr) {
      if (cid != "IHDR" || n < 13) fail("broken PNG file (no IHDR first)");
      PngHeader& h = png->h;
      h.width = be32(body);
      h.height = be32(body + 4);
      h.depth = body[8];
      h.ctype = body[9];
      h.interlace = body[12];
      if (body[11]) fail("unknown PNG filter category");
      if (body[10]) fail("unknown PNG compression method");
      if (h.interlace > 1) fail("unknown PNG interlace method");
      const int d = h.depth;
      const bool ok =
          (h.ctype == 0 && (d == 1 || d == 2 || d == 4 || d == 8 || d == 16)) ||
          (h.ctype == 3 && (d == 1 || d == 2 || d == 4 || d == 8)) ||
          ((h.ctype == 2 || h.ctype == 4 || h.ctype == 6) &&
           (d == 8 || d == 16));
      if (!ok)
        fail("unknown PNG mode (bit depth " + std::to_string(d) +
             ", colour type " + std::to_string(h.ctype) + ")");
      if (h.width == 0 || h.height == 0 || h.width > 0x7FFFFFFF ||
          h.height > 0x7FFFFFFF)
        fail("bad PNG image size");
      seen_ihdr = true;
      if (header_only) return;
      continue;
    }
    if (cid == "IDAT") {
      if (!idat_done) {  // the first run of IDATs is the image
        png->idat.insert(png->idat.end(), body, body + n);
        idat_run = true;
      }
      continue;
    }
    if (idat_run) idat_done = true;
    if (cid == "IEND") break;
    if (cid == "PLTE" && png->h.ctype == 3 && !idat_done) {
      if (n % 3) fail("broken PNG file (PLTE length)");
      const int k = int(n / 3) < 256 ? int(n / 3) : 256;
      std::memcpy(png->palette, body, size_t(k) * 3);
      png->palette_entries = k;
    }
  }
  if (!idat_done && !idat_run) fail("the PNG file has no IDAT chunk");
  if (png->h.ctype == 3 && png->palette_entries == 0)
    fail("a palette PNG without PLTE");
}

// one sample of a packed row: depth 1, 2, 4 (the first sample in the high
// bits), 8 or 16 (big-endian)
inline int sample(const uint8_t* row, size_t i, int depth) {
  switch (depth) {
    case 8: return row[i];
    case 16: return (row[2 * i] << 8) | row[2 * i + 1];
    case 1: return (row[i >> 3] >> (7 - (i & 7))) & 1;
    case 2: return (row[i >> 2] >> (6 - 2 * (i & 3))) & 3;
    default: return (row[i >> 1] >> (4 - 4 * (i & 1))) & 15;
  }
}

// the five filters (PNG 9), in place on one row; prev is the unfiltered
// row above or nullptr at a pass's first row
void unfilter(int type, uint8_t* row, const uint8_t* prev, size_t n,
              int bpp) {
  switch (type) {
    case 0: return;
    case 1:
      for (size_t i = size_t(bpp); i < n; i++) row[i] += row[i - bpp];
      return;
    case 2:
      if (prev)
        for (size_t i = 0; i < n; i++) row[i] += prev[i];
      return;
    case 3:
      for (size_t i = 0; i < n; i++) {
        const int a = i >= size_t(bpp) ? row[i - bpp] : 0;
        const int b = prev ? prev[i] : 0;
        row[i] += uint8_t((a + b) >> 1);
      }
      return;
    case 4:
      for (size_t i = 0; i < n; i++) {
        const int a = i >= size_t(bpp) ? row[i - bpp] : 0;
        const int b = prev ? prev[i] : 0;
        const int c = prev && i >= size_t(bpp) ? prev[i - bpp] : 0;
        const int p = a + b - c;
        const int pa = std::abs(p - a), pb = std::abs(p - b),
                  pc = std::abs(p - c);
        row[i] += uint8_t(pa <= pb && pa <= pc ? a : pb <= pc ? b : c);
      }
      return;
    default:
      fail("broken PNG file (unknown filter type " + std::to_string(type) +
           ")");
  }
}

// PIL's pixel (as convert("RGB") or the grey value convert("L") of a grey
// mode sees it) of pixel x of an unfiltered row
inline void png_pixel(const Png& png, const uint8_t* row, size_t x,
                      uint8_t* o) {
  const PngHeader& h = png.h;
  const int d = h.depth;
  switch (h.ctype) {
    case 0: {
      const int v = sample(row, x, d);
      o[0] = uint8_t(d == 1 ? v * 255 : d == 2 ? v * 85 : d == 4 ? v * 17
                     : d == 8 ? v : (v > 255 ? 255 : v));  // "I;16" clips
      return;
    }
    case 3: {
      const int i = sample(row, x, d);
      if (i < png.palette_entries) {
        o[0] = png.palette[i][0];
        o[1] = png.palette[i][1];
        o[2] = png.palette[i][2];
      } else {
        o[0] = o[1] = o[2] = 0;
      }
      return;
    }
    default: {  // 2, 4, 6: the high byte of a 16-bit sample
      const int s = h.samples(), k = d == 16 ? 2 : 1;
      const uint8_t* px = row + size_t(x) * s * k;
      for (int c = 0; c < h.out_channels(); c++) o[c] = px[c * k];
      return;
    }
  }
}

void decode_png(const uint8_t* data, size_t len, Pixels* px) {
  Png png;
  png_chunks(data, len, &png, false);
  const PngHeader& h = png.h;
  const int bits = h.depth * h.samples();
  const int bpp = bits >= 8 ? bits / 8 : 1;
  // Adam7's passes: (x0, y0, dx, dy); one pass of step 1 otherwise
  static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                   {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                   {0, 1, 1, 2}};
  static const int kWhole[1][4] = {{0, 0, 1, 1}};
  const int (*passes)[4] = h.interlace ? kAdam7 : kWhole;
  const int npass = h.interlace ? 7 : 1;
  size_t need = 0;
  for (int k = 0; k < npass; k++) {
    const size_t pw = (h.width - passes[k][0] + passes[k][2] - 1) / passes[k][2];
    const size_t ph = (h.height - passes[k][1] + passes[k][3] - 1) / passes[k][3];
    if (pw && ph) need += ph * (1 + (pw * bits + 7) / 8);
  }
  std::vector<uint8_t> raw = zlib_inflate(png.idat.data(), png.idat.size(), need);
  if (raw.size() < need)
    fail("the PNG image data ends early (truncated)");
  px->width = int(h.width);
  px->height = int(h.height);
  px->channels = h.out_channels();
  px->allocate();
  size_t at = 0;
  for (int k = 0; k < npass; k++) {
    const int x0 = passes[k][0], y0 = passes[k][1];
    const int dx = passes[k][2], dy = passes[k][3];
    const size_t pw = (h.width - x0 + dx - 1) / dx;
    const size_t ph = (h.height - y0 + dy - 1) / dy;
    if (!pw || !ph) continue;
    const size_t n = (pw * bits + 7) / 8;
    const uint8_t* prev = nullptr;
    for (size_t r = 0; r < ph; r++) {
      uint8_t* row = &raw[at + 1];
      unfilter(raw[at], row, prev, n, bpp);
      uint8_t* o = px->data.data() +
                   (size_t(y0 + r * dy) * h.width + x0) * px->channels;
      for (size_t x = 0; x < pw; x++, o += size_t(dx) * px->channels)
        png_pixel(png, row, x, o);
      prev = row;
      at += 1 + n;
    }
  }
}

// -------------------------------------------------------------------- BMP

// BmpImagePlugin's reading of a BMP (file_header) or a DIB (no file
// header): the header, the palette, the pixel data's offset
struct Bmp {
  int64_t width = 0, height = 0;
  int bits = 0, direction = -1;  // -1: bottom-up rows, 1: top-down
  uint32_t compression = 0;
  uint32_t colors = 0;
  int pad = 4;  // bytes a palette entry
  // 32/24/16-bit layouts: the byte of R, G, B in a 32- or 24-bit pixel;
  // a 16-bit pixel is 5-5-5 (rgb565 false) or 5-6-5
  int rpos = 2, gpos = 1, bpos = 0;
  bool rgb565 = false;
  bool grey = false;  // the palette is PIL's grey ramp: mode L or 1
  uint8_t palette[256][3];  // RGB
  size_t offset = 0;
};

void bmp_header(const uint8_t* data, size_t len, bool file_header, Bmp* b) {
  size_t p = file_header ? 14 : 0;
  if (len < p + 4) fail("the BMP file ends inside its header (truncated)");
  size_t offset = file_header ? le32(data + 10) : 0;
  const uint32_t hs = le32(data + p);
  if (hs != 12 && hs != 40 && hs != 52 && hs != 56 && hs != 64 &&
      hs != 108 && hs != 124)
    fail("unsupported BMP header type (" + std::to_string(hs) + ")");
  if (len < p + hs) fail("the BMP file ends inside its header (truncated)");
  const uint8_t* hd = data + p + 4;  // PIL's header_data
  p += hs;
  uint32_t masks[4] = {0, 0, 0, 0};
  if (hs == 12) {
    b->width = le16(hd);
    b->height = le16(hd + 2);
    b->bits = le16(hd + 6);
    b->compression = 0;
    b->pad = 3;
  } else {
    const bool flip = hd[7] == 0xFF;
    b->direction = flip ? 1 : -1;
    b->width = le32(hd);
    b->height = flip ? int64_t(4294967296LL - le32(hd + 4)) : le32(hd + 4);
    b->bits = le16(hd + 10);
    b->compression = le32(hd + 12);
    b->colors = le32(hd + 28);
    if (b->compression == 3) {
      if (hs - 4 >= 48) {
        const int k = hs - 4 >= 52 ? 4 : 3;
        for (int i = 0; i < k; i++) masks[i] = le32(hd + 36 + 4 * i);
      } else {  // after a 40-byte header, three masks
        if (len < p + 12) fail("the BMP file ends inside its masks");
        for (int i = 0; i < 3; i++) masks[i] = le32(data + p + 4 * i);
        p += 12;
      }
    }
  }
  if (b->width <= 0 || b->height <= 0 || b->width > 0x7FFFFFFF ||
      b->height > 0x7FFFFFFF)
    fail("bad BMP image size");
  const int bits = b->bits;
  if (!b->colors) b->colors = bits < 32 ? (1u << bits) : 0;
  if (file_header && offset == 14 + hs && bits <= 8)
    offset += 4 * size_t(b->colors);
  if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 &&
      bits != 32)
    fail("unsupported BMP pixel depth (" + std::to_string(bits) + ")");
  if (b->compression == 3) {  // BITFIELDS: PIL's SUPPORTED masks
    const uint32_t r = masks[0], g = masks[1], bl = masks[2], a = masks[3];
    auto byte_of = [](uint32_t m) {
      return m == 0xFF ? 0 : m == 0xFF00 ? 1 : m == 0xFF0000 ? 2 : 3;
    };
    bool ok = false;
    if (bits == 32) {
      static const uint32_t kSupported[8][4] = {
          {0xFF0000, 0xFF00, 0xFF, 0x0},
          {0xFF000000, 0xFF0000, 0xFF00, 0x0},
          {0xFF000000, 0xFF00, 0xFF, 0x0},
          {0xFF000000, 0xFF0000, 0xFF00, 0xFF},
          {0xFF, 0xFF00, 0xFF0000, 0xFF000000},
          {0xFF0000, 0xFF00, 0xFF, 0xFF000000},
          {0xFF000000, 0xFF00, 0xFF, 0xFF0000},
          {0x0, 0x0, 0x0, 0x0}};
      for (const auto& m : kSupported)
        if (m[0] == r && m[1] == g && m[2] == bl && m[3] == a) ok = true;
      if (ok && r) {
        b->rpos = byte_of(r);
        b->gpos = byte_of(g);
        b->bpos = byte_of(bl);
      }  // all-zero masks: BGRA
    } else if (bits == 24) {
      ok = r == 0xFF0000 && g == 0xFF00 && bl == 0xFF;
    } else if (bits == 16) {
      if (r == 0xF800 && g == 0x7E0 && bl == 0x1F) ok = b->rgb565 = true;
      ok = ok || (r == 0x7C00 && g == 0x3E0 && bl == 0x1F);
    }
    if (!ok) fail("unsupported BMP bitfields layout");
  } else if (b->compression == 1 || b->compression == 2) {
    if (bits != (b->compression == 1 ? 8 : 4))
      fail("unsupported BMP compression (RLE" +
           std::string(b->compression == 1 ? "8" : "4") + " at " +
           std::to_string(bits) + " bits)");
  } else if (b->compression != 0) {
    fail("unsupported BMP compression (" + std::to_string(b->compression) +
         ")");
  }
  if (bits <= 8) {
    if (b->colors == 0 || b->colors > 65536)
      fail("unsupported BMP palette size (" + std::to_string(b->colors) + ")");
    const size_t n = size_t(b->colors) * b->pad;
    if (len < p + n) fail("the BMP file ends inside its palette (truncated)");
    const uint8_t* pal = data + p;
    p += n;
    bool grey = true;
    for (uint32_t i = 0; i < b->colors; i++) {
      const int v = b->colors == 2 ? (i ? 255 : 0) : int(i & 255);
      const uint8_t* e = pal + size_t(i) * b->pad;
      if (e[0] != v || e[1] != v || e[2] != v) grey = false;
    }
    // PIL reads a grey palette's samples as mode "1" (two entries) or "L"
    // whatever the depth: right only at 1 bit with 2 entries, or at 8 bits
    // (RLE8 and RLE4 give it one sample a byte, and right values, but not
    // with 2 entries)
    if (grey) {
      const bool rle = b->compression == 1 || b->compression == 2;
      const bool right = b->colors == 2 ? (bits == 1 && !rle)
                                        : (bits == 8 || rle);
      if (!right)
        fail("a " + std::to_string(bits) + "-bit BMP whose palette is the "
             "grey ramp of " + std::to_string(b->colors) +
             " entries, which Pillow 12.1 unpacks at the wrong width");
    }
    b->grey = grey;
    std::memset(b->palette, 0, sizeof b->palette);
    for (uint32_t i = 0; i < b->colors && i < 256; i++) {
      const uint8_t* e = pal + size_t(i) * b->pad;  // B, G, R
      b->palette[i][0] = e[2];
      b->palette[i][1] = e[1];
      b->palette[i][2] = e[0];
    }
  }
  b->offset = offset ? offset : p;
}

// BmpRleDecoder.decode: the indices in file row order, as many as it
// makes (at least width * height, else the file is refused)
std::vector<uint8_t> bmp_rle(const uint8_t* data, size_t len, const Bmp& b) {
  const bool rle4 = b.compression == 2;
  const size_t xsize = size_t(b.width);
  const size_t dest = xsize * size_t(b.height);
  std::vector<uint8_t> out;
  out.reserve(dest);
  size_t p = b.offset, x = 0;
  while (out.size() < dest) {
    if (len < p + 2) break;
    size_t num = data[p];
    const int byte = data[p + 1];
    p += 2;
    if (num) {  // a run
      if (x + num > xsize) num = x < xsize ? xsize - x : 0;
      for (size_t i = 0; i < num; i++)
        out.push_back(uint8_t(rle4 ? (i % 2 ? byte & 15 : byte >> 4) : byte));
      x += num;
    } else if (byte == 0) {  // end of line
      while (out.size() % xsize) out.push_back(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: PIL reads two bytes, then moves by
                             // the next two
      if (len < p + 2) break;
      p += 2;
      if (len < p + 2) fail("the BMP RLE data ends in a delta (truncated)");
      const size_t right = data[p], up = data[p + 1];
      p += 2;
      out.insert(out.end(), right + up * xsize, 0);
      x = out.size() % xsize;
    } else {  // absolute mode
      const size_t count = rle4 ? size_t(byte) / 2 : size_t(byte);
      const size_t got = len - p < count ? len - p : count;
      for (size_t i = 0; i < got; i++) {
        const int v = data[p + i];
        if (rle4) {
          out.push_back(uint8_t(v >> 4));
          out.push_back(uint8_t(v & 15));
        } else {
          out.push_back(uint8_t(v));
        }
      }
      p += got;
      if (got < count) break;
      x += size_t(byte);
      if (p % 2) p++;  // the file position's word boundary
    }
  }
  if (out.size() < dest) fail("the BMP RLE data ends early (truncated)");
  return out;
}

inline void put_index(const Bmp& b, int i, uint8_t* o, int channels) {
  if (b.grey) {  // mode L or 1: the sample is the grey value
    o[0] = uint8_t(b.colors == 2 ? (i ? 255 : 0) : i);
    if (channels == 3) o[1] = o[2] = o[0];
    return;
  }
  if (uint32_t(i) < b.colors && i < 256) {
    o[0] = b.palette[i][0];
    o[1] = b.palette[i][1];
    o[2] = b.palette[i][2];
  } else {
    o[0] = o[1] = o[2] = 0;
  }
}

void decode_bmp(const uint8_t* data, size_t len, bool file_header,
                Pixels* px) {
  Bmp b;
  bmp_header(data, len, file_header, &b);
  const size_t W = size_t(b.width), H = size_t(b.height);
  px->width = int(W);
  px->height = int(H);
  px->channels = b.grey ? 1 : 3;
  px->allocate();
  const int ch = px->channels;
  auto out_row = [&](size_t file_row) {  // the image row of a file row
    const size_t y = b.direction < 0 ? H - 1 - file_row : file_row;
    return px->data.data() + y * W * ch;
  };
  if (b.compression == 1 || b.compression == 2) {
    std::vector<uint8_t> idx = bmp_rle(data, len, b);
    for (size_t r = 0; r < H; r++) {
      uint8_t* o = out_row(r);
      for (size_t x = 0; x < W; x++) put_index(b, idx[r * W + x], o + x * ch, ch);
    }
    return;
  }
  const size_t stride = ((W * b.bits + 31) >> 3) & ~size_t(3);
  if (b.offset > len || (len - b.offset) / stride < H)
    fail("the BMP pixel data ends early (truncated)");
  for (size_t r = 0; r < H; r++) {
    const uint8_t* row = data + b.offset + r * stride;
    uint8_t* o = out_row(r);
    switch (b.bits) {
      case 1: case 4: case 8:
        for (size_t x = 0; x < W; x++)
          put_index(b, sample(row, x, b.bits), o + x * ch, ch);
        break;
      case 16:
        for (size_t x = 0; x < W; x++, o += 3) {
          const int v = le16(row + 2 * x);
          if (b.rgb565) {
            o[0] = uint8_t(((v >> 11) & 31) * 255 / 31);
            o[1] = uint8_t(((v >> 5) & 63) * 255 / 63);
          } else {
            o[0] = uint8_t(((v >> 10) & 31) * 255 / 31);
            o[1] = uint8_t(((v >> 5) & 31) * 255 / 31);
          }
          o[2] = uint8_t((v & 31) * 255 / 31);
        }
        break;
      default: {  // 24, 32
        const int k = b.bits / 8;
        for (size_t x = 0; x < W; x++, o += 3) {
          const uint8_t* q = row + x * k;
          o[0] = q[b.rpos];
          o[1] = q[b.gpos];
          o[2] = q[b.bpos];
        }
      }
    }
  }
}

// -------------------------------------------------------------------- PNM

inline bool pnm_space(int c) {
  return c == ' ' || c == '\t' || c == '\n' || c == 0x0B || c == 0x0C ||
         c == '\r';
}

// PpmImageFile._read_token from position *p (one character at a time;
// a "#" skips to and past the line's end, inside a token too)
std::string pnm_token(const uint8_t* data, size_t len, size_t* p) {
  std::string token;
  while (token.size() <= 10) {
    if (*p >= len) break;
    const int c = data[(*p)++];
    if (pnm_space(c)) {
      if (token.empty()) continue;
      break;
    }
    if (c == '#') {
      while (*p < len) {
        const int e = data[(*p)++];
        if (e == '\r' || e == '\n') break;
      }
      continue;
    }
    token += char(c);
  }
  if (token.empty()) fail("reached EOF while reading the PNM header");
  if (token.size() > 10) fail("token too long in the PNM header");
  return token;
}

int64_t pnm_int(const std::string& t) {
  if (t.empty() || t.size() > 10) fail("bad number in the PNM header");
  int64_t v = 0;
  for (char c : t) {
    if (c < '0' || c > '9') fail("bad number in the PNM header: " + t);
    v = v * 10 + (c - '0');
  }
  return v;
}

// Python's round(v / maxval * out_max): doubles, then half to even
inline int64_t pil_scale(int64_t v, int64_t maxval, int64_t out_max) {
  return int64_t(std::nearbyint(double(v) / double(maxval) * double(out_max)));
}

inline uint8_t clip255(int64_t v) { return uint8_t(v > 255 ? 255 : v); }

struct PnmHeader {
  int kind = 0;  // 1..6
  int64_t width = 0, height = 0, maxval = 1;
  size_t data = 0;  // where the pixel data starts
};

// PpmImageFile._open: the magic (up to 6 bytes, to a whitespace), then
// the width, height and (but for P1 and P4) maxval tokens
PnmHeader pnm_header(const uint8_t* data, size_t len) {
  PnmHeader h;
  size_t p = 0;
  std::string magic;
  for (int i = 0; i < 6 && p < len; i++) {
    const int c = data[p++];
    if (pnm_space(c)) break;
    magic += char(c);
  }
  if (magic.size() != 2 || magic[0] != 'P' || magic[1] < '1' || magic[1] > '6')
    fail("not a PNM file the port reads (magic " + magic + ")");
  h.kind = magic[1] - '0';
  h.width = pnm_int(pnm_token(data, len, &p));
  h.height = pnm_int(pnm_token(data, len, &p));
  if (h.width <= 0 || h.height <= 0 || h.width > 0x7FFFFFFF ||
      h.height > 0x7FFFFFFF)
    fail("bad PNM image size");
  if (h.kind != 1 && h.kind != 4) {
    h.maxval = pnm_int(pnm_token(data, len, &p));
    if (h.maxval <= 0 || h.maxval >= 65536)
      fail("maxval must be greater than 0 and less than 65536");
  }
  h.data = p;
  return h;
}

void decode_pnm(const uint8_t* data, size_t len, Pixels* px) {
  const PnmHeader h = pnm_header(data, len);
  const int kind = h.kind;
  const bool bitmap = kind == 1 || kind == 4, colour = kind == 3 || kind == 6;
  const bool plain = kind <= 3;
  const int64_t W = h.width, H = h.height, maxval = h.maxval;
  size_t p = h.data;
  const int bands = colour ? 3 : 1;
  // grey with maxval > 255 is mode "I" (0..65535), which convert clips
  const bool mode_i = !colour && !bitmap && maxval > 255;
  const int64_t out_max = mode_i ? 65535 : 255;
  px->width = int(W);
  px->height = int(H);
  px->channels = bands;
  px->allocate();
  uint8_t* o = px->data.data();
  const size_t total = size_t(W) * size_t(H) * bands;
  if (bitmap && !plain) {  // P4: "1;I", rows of whole bytes, 1 is black
    const size_t stride = (size_t(W) + 7) / 8;
    if (p > len || (len - p) / stride < size_t(H))
      fail("the PNM pixel data ends early (truncated)");
    for (int64_t y = 0; y < H; y++)
      for (int64_t x = 0; x < W; x++)
        o[y * W + x] = sample(data + p + y * stride, size_t(x), 1) ? 0 : 255;
    return;
  }
  if (!plain) {  // P5, P6
    const int in_bytes = maxval < 256 ? 1 : 2;
    if (p > len || (len - p) / in_bytes < total)
      fail("the PNM pixel data ends early (truncated)");
    const uint8_t* s = data + p;
    for (size_t i = 0; i < total; i++) {
      const int64_t v = in_bytes == 1 ? s[i] : (s[2 * i] << 8) | s[2 * i + 1];
      // raw at maxval 255 (and 65535 for grey: "I;16B"), else PpmDecoder's
      // min(out_max, round(v / maxval * out_max))
      int64_t u = (maxval == 255 || (mode_i && maxval == 65535))
                      ? v : pil_scale(v, maxval, out_max);
      if (u > out_max) u = out_max;
      o[i] = clip255(u);
    }
    return;
  }
  // P1-P3: PpmPlainDecoder, comments ("#" to the line's end) removed
  // from the data first
  size_t i = 0;
  std::string token;
  auto put = [&](const std::string& t) {
    if (bitmap) {
      for (char c : t) {
        if (i == total) return;
        if (c != '0' && c != '1')
          fail(std::string("invalid token for this mode: ") + c);
        o[i++] = c == '1' ? 0 : 255;
      }
      return;
    }
    if (i == total) return;
    if (t.size() > 10) fail("token too long found in the PNM data");
    const int64_t v = pnm_int(t);
    if (v > maxval) fail("channel value too large for this mode");
    o[i++] = clip255(pil_scale(v, maxval, out_max));
  };
  while (p < len && i < total) {
    const int c = data[p++];
    if (c == '#') {
      while (p < len && data[p] != '\n' && data[p] != '\r') p++;
      if (p < len) p++;
      continue;
    }
    if (pnm_space(c)) {
      if (!token.empty()) put(token);
      token.clear();
      continue;
    }
    token += char(c);
    if (token.size() > 10 && !bitmap)
      fail("token too long found in the PNM data");
  }
  if (!token.empty()) put(token);
  if (i < total) fail("the PNM pixel data ends early (truncated)");
}

// --------------------------------------------------------------- sniffing

bool starts(const uint8_t* d, size_t n, const char* s, size_t k) {
  return n >= k && std::memcmp(d, s, k) == 0;
}

// The format of a file's first bytes, in PIL's order of plugins; name
// receives the name of a format the port does not decode.
Format sniff(const uint8_t* d, size_t n, std::string* name) {
  if (starts(d, n, "BM", 2)) return kBmp;
  if (n >= 4) {
    const uint32_t hs = le32(d);
    if (hs == 12 || hs == 40 || hs == 52 || hs == 56 || hs == 64 ||
        hs == 108 || hs == 124)
      return kBmp;  // a DIB: no file header
  }
  if (starts(d, n, "\xFF\xD8\xFF", 3)) return kJpeg;
  if (n >= 2 && d[0] == 'P' && d[1] >= '1' && d[1] <= '6') return kPnm;
  if (starts(d, n, reinterpret_cast<const char*>(kPngMagic), 8)) return kPng;
  struct Magic {
    const char* bytes;
    size_t len;
    const char* name;
  };
  static const Magic kMagics[] = {
      {"GIF87a", 6, "GIF"}, {"GIF89a", 6, "GIF"},
      {"II*\0", 4, "TIFF"}, {"MM\0*", 4, "TIFF"},
      {"II+\0", 4, "BigTIFF"}, {"MM\0+", 4, "BigTIFF"},
      {"\xFF\x4F\xFF\x51", 4, "JPEG 2000 (codestream)"},
      {"\0\0\0\x0cjP  \r\n\x87\n", 12, "JPEG 2000 (JP2)"},
      {"qoif", 4, "QOI"}, {"\0\0\1\0", 4, "ICO"}, {"\0\0\2\0", 4, "CUR"},
      {"8BPS", 4, "PSD"}, {"DDS ", 4, "DDS"}, {"icns", 4, "ICNS"},
      {"BLP1", 4, "BLP"}, {"BLP2", 4, "BLP"}, {"%!PS", 4, "EPS"},
      {"\xC5\xD0\xD3\xC6", 4, "EPS"}, {"SIMPLE", 6, "FITS"},
      {"\x89HDF\r\n\x1a\n", 8, "HDF5"}, {"FTEX", 4, "FTEX"},
      {"\xD0\xCF\x11\xE0\xA1\xB1\x1A\xE1", 8, "FPX or MIC (OLE)"},
      {"\0\0\1\xB3", 4, "MPEG"}, {"DanM", 4, "MSP"}, {"LinS", 4, "MSP"},
      {"\x80\xE8\0\0", 4, "PIXAR"}, {"P7 332", 6, "XV thumbnail"},
      {"/* XPM */", 9, "XPM"}, {"\xD7\xCD\xC6\x9A\0\0", 6, "WMF"},
      {"\x01\0\0\0", 4, "EMF"}, {"BUFR", 4, "BUFR"}, {"ZCZC", 4, "BUFR"},
      {"\0\0\0\0\0\0\0\x04", 8, "McIdas"},
      {"\x59\xA6\x6A\x95", 4, "SUN raster"}};
  for (const Magic& m : kMagics)
    if (starts(d, n, m.bytes, m.len)) {
      // an ICO or CUR names at least one image; a TGA may start the same
      if ((!std::strcmp(m.name, "ICO") || !std::strcmp(m.name, "CUR")) &&
          (n < 6 || le16(d + 4) == 0))
        break;
      *name = m.name;
      return kUnknown;
    }
  if (starts(d, n, "RIFF", 4) && n >= 12 && std::memcmp(d + 8, "WEBP", 4) == 0) {
    *name = "WebP";
  } else if (n >= 12 && std::memcmp(d + 4, "ftyp", 4) == 0) {
    *name = "AVIF or HEIF (ISO media, brand " +
            std::string(reinterpret_cast<const char*>(d + 8), 4) + ")";
  } else if (n >= 2 && d[0] == 'P' && std::strchr("0fy", d[1]) && d[1]) {
    *name = "PFM or a Pillow PNM extension";
  } else if (starts(d, n, "GRIB", 4)) {
    *name = "GRIB";
  } else if (n >= 4 && le32(d) == 987654321) {
    *name = "DCX";
  } else if (n >= 16 && (le16(d + 4) == 0xAF11 || le16(d + 4) == 0xAF12)) {
    *name = "FLI";
  } else if (n >= 2 && d[0] == 10 && (d[1] == 0 || d[1] == 2 || d[1] == 3 ||
                                      d[1] == 5)) {
    *name = "PCX";
  } else if (n >= 2 && ((d[0] << 8) | d[1]) == 474) {
    *name = "SGI";
  } else if (n >= 8 && le32(d) >= 20 && (le32(d + 4) == 1 || le32(d + 4) == 2)) {
    *name = "GBR (GIMP brush)";
  } else {
    size_t i = 0;  // XBM: "#define" after leading whitespace
    while (i < n && pnm_space(d[i])) i++;
    if (starts(d + i, n - i, "#define", 7)) {
      *name = "XBM";
    } else if (n >= 18 && d[1] <= 1 &&
               (d[2] == 1 || d[2] == 2 || d[2] == 3 || d[2] == 9 ||
                d[2] == 10 || d[2] == 11) &&
               (d[16] == 1 || d[16] == 8 || d[16] == 15 || d[16] == 16 ||
                d[16] == 24 || d[16] == 32)) {
      *name = "TGA";  // TGA has no magic: PIL's header checks
    } else {
      *name = "unknown";
    }
  }
  return kUnknown;
}

int report(const char* msg, char* err, int64_t errlen) {
  if (errlen > 0) {
    std::strncpy(err, msg, size_t(errlen - 1));
    err[errlen - 1] = 0;
  }
  return 1;
}

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

// the width and height in a file's header, without decoding it
void header_size(Format f, const uint8_t* d, size_t n, int64_t* h,
                 int64_t* w) {
  if (f == kPng) {
    Png png;
    png_chunks(d, n, &png, true);
    *h = png.h.height;
    *w = png.h.width;
  } else if (f == kBmp) {
    Bmp b;
    bmp_header(d, n, d[0] == 'B' && d[1] == 'M', &b);
    *h = b.height;
    *w = b.width;
  } else {
    const PnmHeader pnm = pnm_header(d, n);
    *h = pnm.height;
    *w = pnm.width;
  }
}

}  // namespace

extern "C" {

// Decode the frame file at path into out, (height, width, channels) uint8
// C-contiguous; channels 3 is PIL's convert("RGB"), 1 its convert("L").
// info receives height, width, the decoded image's channels (the JPEG's
// components), errno and the format (0 JPEG, 1 PNG, 2 BMP, 3 PNM, -1 none
// the port decodes). Returns 0; 1 with a message in err for a file it
// refuses; 2 where the file cannot be read (info[3] = errno); 3, before
// decoding, where capacity (out's bytes) is not height * width *
// channels: call again with such a buffer.
int adt_image_decode_file(const char* path, int channels, uint8_t* out,
                          int64_t capacity, int64_t* info, char* err,
                          int64_t errlen) {
  info[4] = kUnknown;
  std::vector<uint8_t> data;
  try {
    if (channels != 1 && channels != 3) fail("channels must be 1 or 3");
    errno = 0;
    if (!read_file(path, &data)) {
      info[3] = errno;
      return 2;
    }
    const uint8_t* d = data.data();
    const size_t n = data.size();
    std::string name;
    const Format f = sniff(d, n, &name);
    info[4] = f;
    if (f == kUnknown)
      fail((name == "unknown" ? std::string("not an image file of a format "
                                            "PIL sniffs")
                              : "a " + name + " file") +
           ": the port decodes JPEG, PNG, BMP and PNM frames");
    if (f == kJpeg)
      return adt_jpeg_decode_buffer(d, int64_t(n), channels, out, capacity,
                                    info, err, errlen);
    int64_t h = 0, w = 0;
    header_size(f, d, n, &h, &w);
    info[0] = h;
    info[1] = w;
    if (h * w > kMaxPixels)  // PIL's DecompressionBombError
      fail("an image of " + std::to_string(h * w) + " pixels, more than "
           "PIL opens (2 * Image.MAX_IMAGE_PIXELS)");
    if (capacity != h * w * channels) return 3;
    Pixels px;
    if (f == kPng) {
      decode_png(d, n, &px);
    } else if (f == kBmp) {
      decode_bmp(d, n, d[0] == 'B' && d[1] == 'M', &px);
    } else {
      decode_pnm(d, n, &px);
    }
    info[2] = px.channels;
    const size_t pixels = size_t(w) * size_t(h);
    const uint8_t* s = px.data.data();
    if (px.channels == channels) {
      std::memcpy(out, s, pixels * channels);
    } else if (channels == 3) {  // grey -> RGB replicates
      for (size_t i = 0; i < pixels; i++)
        out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = s[i];
    } else {  // RGB -> L: PIL's luma
      for (size_t i = 0; i < pixels; i++, s += 3)
        out[i] = uint8_t((s[0] * 19595 + s[1] * 38470 + s[2] * 7471 +
                          0x8000) >> 16);
    }
    return 0;
  } catch (const std::exception& e) {  // ImageError, std::bad_alloc
    return report(e.what(), err, errlen);
  }
}

}  // extern "C"
