"""The port's frame decoder: ctypes binding to ``csrc/image_decode.cpp``
and ``csrc/jpeg_decode.cpp``, one library.

:func:`decode_image` gives the bytes of PIL's ``Image.open(path).convert(
mode)`` for ``mode`` ``"RGB"`` (``(H, W, 3)``) or ``"L"`` (``(H, W)``),
uint8 and C-contiguous, without PIL, for every frame format the port
reads. Like PIL it goes by the file's first bytes, never its name, so a
PNG saved as ``img_00001.jpg`` decodes as a PNG:

* JPEG (``FF D8 FF``): the decoder of :mod:`.jpeg`, every 8-bit JPEG PIL
  decodes;
* PNG: colour types 0, 2, 3, 4 and 6 at every bit depth, the five row
  filters, Adam7, PLTE and tRNS, on an inflate of the port's own, every
  chunk's CRC and the Adler-32 checked;
* BMP and headerless DIB: 1, 4, 8, 16, 24 and 32 bits, BI_RGB, BI_RLE8,
  BI_RLE4 and the BI_BITFIELDS layouts PIL supports, bottom-up and
  top-down, the OS/2 core header and the 40- to 124-byte info headers;
* PNM: P1-P6, any maxval, 16-bit samples.

Each is read as Pillow 12.1 reads it (its modes, then ``convert``: alpha
dropped, a palette looked up, 16-bit grey and PNM's mode ``"I"`` clipped
to 255, colour to ``"L"`` by PIL's integer luma; see the source's head).
Every other format PIL sniffs (GIF, TIFF, WebP, AVIF, JPEG 2000, QOI,
TGA, ICO, ...) raises ``ValueError`` naming the file and the format, as
does a truncated file, a bad CRC or Adler-32 and what PIL refuses; a file
that cannot be read raises ``OSError``, as PIL's ``open`` does. Nothing
falls back to PIL or to a grey frame.

The library, ``libadt_image``, is built with g++ at the first decode
(never at import) into ``action_detection_torch/_build/``; a failed build
raises ``ImportError`` with the compiler's log. ``ctypes.CDLL`` releases
the GIL around each call (one a decode: the library reads the file too),
and the library keeps its state per call, so the decode pool's threads
overlap. Each decode adds one to the counter of its format
(:data:`DECODES`; ``kernels.launch_counts()`` lists them as
``host_jpeg_decode``, ``host_png_decode``, ``host_bmp_decode`` and
``host_pnm_decode``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np

from ..utils.build import BUILD_DIR, CSRC, build_host_library

SOURCES = [os.path.join(CSRC, "jpeg_decode.cpp"),
           os.path.join(CSRC, "image_decode.cpp")]
#: the library's format codes (``info[4]``) in order
FORMATS = ("jpeg", "png", "bmp", "pnm")
_ERR_BYTES = 512
_count_lock = threading.Lock()
#: the shape of the last decode in each mode: a video's frames share one,
#: so the output buffer is right before the call (else the library says so
#: before decoding, and the call is made again)
_last_shape = {}

_ENTRY = [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
          ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64]
SIGNATURES = {
    # path, channels, out, out's bytes, info (h, w, channels, errno,
    # format), err, err capacity
    "adt_image_decode_file": _ENTRY,
    # the same, JPEG files only (info without the format)
    "adt_jpeg_decode_file": _ENTRY,
}


class DecodeCounter:
    """The decodes of one format: ``launches``, as a kernel wrapper counts
    its launches."""

    def __init__(self):
        self.launches = 0


#: one counter a format, by :data:`FORMATS` name
DECODES = {f: DecodeCounter() for f in FORMATS}


def build_decoder(build_dir: str = BUILD_DIR) -> str:
    """Compile the decoder's sources unless they and the command have a
    library in ``build_dir`` already; returns its path."""
    return build_host_library("libadt_image", SOURCES, "the frame decoder",
                              build_dir)


@functools.lru_cache(maxsize=None)
def load_decoder() -> ctypes.CDLL:
    """The built decoder library with its entry points' signatures set."""
    lib = ctypes.CDLL(build_decoder())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def decode_with(entry: str, path: str, mode: str, count=None) -> np.ndarray:
    """One decode of ``path`` through the library's ``entry`` (rc 3: the
    output buffer was the wrong size, so the call is made again with the
    size the library reported). ``count`` is the counter to add one to, or
    None for the counter of the format the library sniffed."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"decode: mode {mode!r}, not 'RGB' or 'L'")
    channels = 3 if mode == "RGB" else 1
    fn = getattr(load_decoder(), entry)
    err = ctypes.create_string_buffer(_ERR_BYTES)
    info = np.full(5, -1, dtype=np.int64)
    out = np.empty(_last_shape.get(mode, (0,)), dtype=np.uint8)
    for _ in range(2):
        rc = fn(os.fsencode(path), channels, out.ctypes.data, out.size,
                info.ctypes.data, err, _ERR_BYTES)
        shape = (int(info[0]), int(info[1])) + ((3,) if channels == 3 else ())
        if rc != 3:
            break
        out = np.empty(shape, np.uint8)
        _last_shape[mode] = shape
    if count is None and info[4] >= 0:
        count = DECODES[FORMATS[int(info[4])]]
    if count is not None:
        with _count_lock:
            count.launches += 1
    if rc == 2:
        raise OSError(int(info[3]), os.strerror(int(info[3])), path)
    if rc:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return out.reshape(shape)    # the same bytes as a (W, H) buffer's


def decode_image(path: str, mode: str = "RGB") -> np.ndarray:
    """The pixels of the JPEG, PNG, BMP or PNM file at ``path`` as PIL's
    ``convert(mode)`` gives them: ``(H, W, 3)`` for ``"RGB"``, ``(H, W)``
    for ``"L"``, uint8. One library call reads, sniffs and decodes the
    file, the GIL released."""
    return decode_with("adt_image_decode_file", path, mode)
