"""Lossless frame writers for the decoder's tests and ``chip_smoke.py``:
PNG, BMP (and DIB) and PNM files from numpy arrays, with the structures
PIL's own writers never make (Adam7, a chosen filter a row, 16-bit colour,
IDAT split over chunks, stored and fixed-Huffman deflate, RLE8 and RLE4,
BI_BITFIELDS, every BMP header size, top-down rows, PNM maxvals other than
255 and comments). numpy, zlib and struct only: no PIL, no JAX.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterable, Optional, Sequence

import numpy as np

PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
#: Adam7's passes: (x0, y0, dx, dy)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
#: samples a pixel of each PNG colour type
PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def png_chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def pack_samples(values: np.ndarray, depth: int) -> bytes:
    """One row of samples packed at ``depth`` bits (the first sample in
    the high bits; 16-bit big-endian)."""
    v = np.asarray(values, np.int64).ravel()
    if depth == 16:
        return v.astype(">u2").tobytes()
    if depth == 8:
        return v.astype(np.uint8).tobytes()
    per = 8 // depth
    v = np.concatenate([v, np.zeros(-len(v) % per, np.int64)]).reshape(-1, per)
    shifts = 8 - depth * (np.arange(per) + 1)
    return (v << shifts).sum(1).astype(np.uint8).tobytes()


def filter_row(kind: int, row: bytes, prev: Optional[bytes],
               bpp: int) -> bytes:
    """PNG filter ``kind`` (0-4) of one packed row against the row above
    (None at a pass's first row): the filter byte, then the row."""
    r = np.frombuffer(row, np.uint8).astype(np.int16)
    b = (np.frombuffer(prev, np.uint8).astype(np.int16) if prev is not None
         else np.zeros_like(r))
    a = np.concatenate([np.zeros(bpp, np.int16), r[:-bpp]])[:len(r)]
    c = np.concatenate([np.zeros(bpp, np.int16), b[:-bpp]])[:len(r)]
    if kind == 0:
        f = r
    elif kind == 1:
        f = r - a
    elif kind == 2:
        f = r - b
    elif kind == 3:
        f = r - (a + b) // 2
    else:
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        f = r - np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return bytes([kind]) + (f & 255).astype(np.uint8).tobytes()


def png_bytes(samples: np.ndarray, depth: int, ctype: int, *,
              palette: Optional[np.ndarray] = None,
              trns: Optional[bytes] = None, interlace: bool = False,
              filters: Sequence[int] = (0,), idat_chunk: int = 0,
              level: int = 6, strategy: int = zlib.Z_DEFAULT_STRATEGY,
              before: Iterable[bytes] = (), after: Iterable[bytes] = ()
              ) -> bytes:
    """A PNG of ``samples`` (``(H, W)`` or ``(H, W, samples)`` integers at
    ``depth`` bits, colour type ``ctype``). ``filters`` cycle over the
    rows of each pass; ``idat_chunk`` > 0 splits the zlib stream into
    IDATs of that many bytes; ``level``/``strategy`` go to zlib (level 0:
    stored blocks, ``zlib.Z_FIXED``: fixed Huffman codes); ``before`` and
    ``after`` are extra chunks (``png_chunk``) around the image data."""
    s = np.asarray(samples)
    if s.ndim == 2:
        s = s[..., None]
    h, w, n = s.shape
    assert n == PNG_SAMPLES[ctype]
    bits = depth * n
    bpp = max(1, bits // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw, k = bytearray(), 0
    for x0, y0, dx, dy in passes:
        sub = s[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prev = None
        for row in sub:
            packed = pack_samples(row, depth)
            raw += filter_row(filters[k % len(filters)], packed, prev, bpp)
            prev, k = packed, k + 1
    z = zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy)
    data = z.compress(bytes(raw)) + z.flush()
    step = idat_chunk or len(data)
    idats = b"".join(png_chunk(b"IDAT", data[i:i + step])
                     for i in range(0, len(data), step))
    head = png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                          0, int(interlace)))
    if palette is not None:
        head += png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        head += png_chunk(b"tRNS", trns)
    return (PNG_MAGIC + head + b"".join(before) + idats + b"".join(after)
            + png_chunk(b"IEND", b""))


def png_rgb(rgb: np.ndarray, interlace: bool = False) -> bytes:
    """An 8-bit RGB PNG of an ``(H, W, 3)`` uint8 frame, each row's filter
    the one of the five with the smallest sum of absolute values (libpng's
    heuristic), or Adam7 with the filters in turn."""
    if interlace:
        return png_bytes(rgb, 8, 2, interlace=True, filters=(0, 1, 2, 3, 4))
    raw, prev = bytearray(), None
    for row in rgb:
        packed = row.tobytes()
        cands = [filter_row(k, packed, prev, 3) for k in range(5)]
        raw += min(cands, key=lambda f: int(
            np.abs(np.frombuffer(f[1:], np.int8).astype(np.int32)).sum()))
        prev = packed
    h, w = rgb.shape[:2]
    return (PNG_MAGIC + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + png_chunk(b"IDAT", zlib.compress(bytes(raw), 6))
        + png_chunk(b"IEND", b""))


# --------------------------------------------------------------------- BMP

def _bmp_rows(pixels: np.ndarray, bits: int, positions=(2, 1, 0),
              filler: int = 0x5A) -> list:
    """The rows of a BI_RGB/BI_BITFIELDS pixel array, top row first, each
    padded to 4 bytes: ``pixels`` are indices (bits <= 8), 16-bit words
    (16) or RGB (24, 32; R, G, B at the byte ``positions`` of a pixel, the
    rest ``filler``)."""
    rows = []
    for row in pixels:
        if bits <= 8:
            b = pack_samples(row, bits)
        elif bits == 16:
            b = np.asarray(row, "<u2").tobytes()
        else:
            px = np.full((len(row), bits // 8), filler, np.uint8)
            for ch, pos in enumerate(positions):
                px[:, pos] = row[:, ch]
            b = px.tobytes()
        rows.append(b + bytes(-len(b) % 4))
    return rows


def bmp_bytes(pixels: np.ndarray, bits: int, *,
              palette: Optional[np.ndarray] = None, header: int = 40,
              compression: int = 0, masks: Optional[Sequence[int]] = None,
              top_down: bool = False, file_header: bool = True,
              data: Optional[bytes] = None, colors: int = 0,
              positions=(2, 1, 0), offset: Optional[int] = None) -> bytes:
    """A BMP (or, without ``file_header``, a DIB). ``header`` is the info
    header's size (12: the OS/2 core header, 3-byte palette entries; 40,
    52, 56, 64, 108, 124); ``palette`` is ``(n, 3)`` RGB; ``colors`` goes
    to biClrUsed; ``masks`` are BI_BITFIELDS's (R, G, B[, A]), inside the
    header from 52 bytes on, else after it; ``data`` replaces the pixel
    rows (an RLE stream); ``offset`` overrides bfOffBits."""
    h, w = pixels.shape[:2]
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h,
                           1, bits, compression, 0, 2835, 2835, colors, 0)
        extra = b""
        if masks is not None and header >= 52:
            extra = struct.pack("<4I", *(list(masks) + [0] * 4)[:4])
        info += (extra + bytes(header))[:header - 40]
    if masks is not None and header < 52:
        info += struct.pack("<3I", *masks[:3])
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, ::-1]      # BGR
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], 1)
        pal = p.tobytes()
    if data is None:
        rows = _bmp_rows(pixels, bits, positions)
        data = b"".join(rows if top_down else rows[::-1])
    if not file_header:
        return info + pal + data
    off = 14 + len(info) + len(pal) if offset is None else offset
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + info
            + pal + data)


def rle_stream(indices: np.ndarray, rle4: bool, seed: int) -> bytes:
    """An RLE8 or RLE4 stream of ``indices`` (bottom row first, as BMP
    stores rows) mixing runs, absolute runs, runs longer than what is left
    of the row, an RLE4 absolute run of odd length (Pillow reads length //
    2 bytes of it), delta escapes as Pillow reads them (two ignored bytes,
    then right and up) and an end of line after each row; the stream ends
    with an end of bitmap. Absolute runs are padded to a 16-bit word of
    the stream (and of the file, whose pixel data starts at an even
    offset)."""
    rng = np.random.RandomState(seed)
    out = bytearray()
    w = indices.shape[1]
    for row in indices[::-1]:
        x = 0
        while x < w:
            left = w - x
            op = rng.randint(4)
            if op == 0 and left >= 3:           # absolute
                n = int(rng.randint(3, min(left, 9) + 1))
                if rle4:
                    if n % 2 and rng.rand() < 0.5:
                        # Pillow reads n // 2 bytes: n - 1 pixels come out
                        vals = row[x:x + n - 1]
                        body = bytes((int(vals[i]) << 4) | int(vals[i + 1])
                                     for i in range(0, n - 1, 2))
                    else:
                        n -= n % 2
                        vals = row[x:x + n]
                        body = bytes((int(vals[i]) << 4) | int(vals[i + 1])
                                     for i in range(0, n, 2))
                else:
                    body = bytes(int(v) for v in row[x:x + n])
                out += bytes([0, n]) + body
                if len(out) % 2:
                    out += b"\x00"
                x += n
            elif op == 1 and left >= 2:         # delta, right only
                right = int(rng.randint(1, min(left, 4) + 1))
                out += bytes([0, 2, 99, 99, right, 0])
                x += right
            else:                               # a run, sometimes too long
                n = int(rng.randint(1, min(left, 6) + 1))
                if n == left and rng.rand() < 0.5:
                    n += int(rng.randint(1, 5))
                v = int(row[x])
                if rle4:
                    v = (v << 4) | int(row[min(x + 1, w - 1)])
                out += bytes([min(n, 255), v])
                x += n
        out += b"\x00\x00"                      # end of line
    return bytes(out + b"\x00\x01")             # end of bitmap


# --------------------------------------------------------------------- PNM

def pnm_bytes(samples: np.ndarray, kind: int, maxval: int = 255,
              comment: bool = False) -> bytes:
    """A P1-P6 file of ``samples`` (``(H, W)`` or ``(H, W, 3)`` integers;
    P1/P4: 1 is black). ``comment`` puts "#" comments in the header (and,
    in plain files, the data)."""
    s = np.asarray(samples, np.int64)
    h, w = s.shape[:2]
    c = b"# a comment\n" if comment else b""
    head = b"P%d\n%s%d %d\n" % (kind, c, w, h)
    if kind not in (1, 4):
        head += b"%s%d\n" % (c, maxval)
    if kind == 4:
        return head + b"".join(pack_samples(r, 1) for r in s)
    if kind in (5, 6):
        return head + s.astype(">u2" if maxval > 255 else np.uint8).tobytes()
    lines = []
    for i, r in enumerate(s.reshape(h, -1)):
        sep = b"" if kind == 1 and i % 2 else b" "   # P1 needs no spaces
        lines.append(sep.join(b"%d" % v for v in r)
                     + (b" # row\n" if comment and i == 0 else b"\n"))
    return head + b"".join(lines)


def ppm_rgb(rgb: np.ndarray) -> bytes:
    """A binary PPM (P6, maxval 255) of an ``(H, W, 3)`` uint8 frame."""
    return pnm_bytes(rgb, 6)
