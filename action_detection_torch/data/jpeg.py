"""The port's JPEG decoder: ctypes binding to ``csrc/jpeg_decode.cpp``.

:func:`decode_jpeg` gives the bytes of PIL's ``Image.open(path).convert(
mode)`` for ``mode`` ``"RGB"`` (``(H, W, 3)``) or ``"L"`` (``(H, W)``),
uint8 and C-contiguous, without PIL: a baseline decoder written after
libjpeg's islow IDCT, fancy upsampling and YCbCr tables (see the source's
head). An ``"L"`` request on a colour file is PIL's integer luma of the RGB
decode, never the file's Y channel. It takes sequential Huffman JPEGs of
8-bit precision with 1 or 3 components; progressive, lossless and
arithmetic-coded files, 12-bit and CMYK files, a truncated file and
anything that is not a JPEG raise ``ValueError`` naming the file and the
cause; a file that cannot be read raises ``OSError`` (``FileNotFoundError``
...), as PIL's ``open`` does. Nothing falls back to PIL or to a grey frame.

The library is its own, ``libadt_jpeg`` (not part of ``libadt_native``),
built with g++ at the first decode (never at import, so runs on synthetic
frames never need it) into ``action_detection_torch/_build/``; a failed
build raises ``ImportError`` with the compiler's log. It is loaded with
``ctypes.CDLL``, which releases the GIL around each call (one a decode:
the library reads the file too), and keeps every piece of decoder state per
call, so the decode pool's threads overlap.
Each decode adds one to ``decode_jpeg.launches`` (``kernels.
launch_counts()`` lists it as ``host_jpeg_decode``).
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading

import numpy as np

from ..utils.build import BUILD_DIR, CSRC, build_host_library

SOURCE = os.path.join(CSRC, "jpeg_decode.cpp")
_ERR_BYTES = 512
_count_lock = threading.Lock()
#: the shape of the last decode in each mode: a video's frames share one,
#: so the output buffer is right before the call (else the library says so
#: before decoding, and the call is made again)
_last_shape = {}

SIGNATURES = {
    # path, channels, out, out's bytes, info (h, w, components, errno),
    # err, err capacity
    "adt_jpeg_decode_file": [ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_int64, ctypes.c_void_p,
                             ctypes.c_char_p, ctypes.c_int64],
}


def build_jpeg(build_dir: str = BUILD_DIR) -> str:
    """Compile ``csrc/jpeg_decode.cpp`` unless this source and command have
    a library in ``build_dir`` already; returns its path."""
    return build_host_library("libadt_jpeg", SOURCE, "the JPEG decoder",
                              build_dir)


@functools.lru_cache(maxsize=None)
def load_jpeg() -> ctypes.CDLL:
    """The built decoder library with its entry points' signatures set."""
    lib = ctypes.CDLL(build_jpeg())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def decode_jpeg(path: str, mode: str = "RGB") -> np.ndarray:
    """The pixels of the JPEG at ``path`` as PIL's ``convert(mode)`` gives
    them: ``(H, W, 3)`` for ``"RGB"``, ``(H, W)`` for ``"L"``, uint8. One
    library call reads and decodes the file, the GIL released."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"decode_jpeg: mode {mode!r}, not 'RGB' or 'L'")
    channels = 3 if mode == "RGB" else 1
    lib = load_jpeg()
    err = ctypes.create_string_buffer(_ERR_BYTES)
    info = np.zeros(4, dtype=np.int64)
    out = np.empty(_last_shape.get(mode, (0,)), dtype=np.uint8)
    with _count_lock:
        decode_jpeg.launches += 1
    for _ in range(2):
        rc = lib.adt_jpeg_decode_file(os.fsencode(path), channels,
                                      out.ctypes.data, out.size,
                                      info.ctypes.data, err, _ERR_BYTES)
        shape = (int(info[0]), int(info[1])) + ((3,) if channels == 3 else ())
        if rc != 3:
            break
        out = np.empty(shape, np.uint8)
        _last_shape[mode] = shape
    if rc == 2:
        raise OSError(int(info[3]), os.strerror(int(info[3])), path)
    if rc:
        raise ValueError(f"{path}: {err.value.decode(errors='replace')}")
    return out.reshape(shape)    # the same bytes as a (W, H) buffer's


decode_jpeg.launches = 0
