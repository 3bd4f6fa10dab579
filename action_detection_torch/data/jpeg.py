"""The port's JPEG decoder: ctypes binding to ``csrc/jpeg_decode.cpp``.

:func:`decode_jpeg` gives the bytes of PIL's ``Image.open(path).convert(
mode)`` for ``mode`` ``"RGB"`` (``(H, W, 3)``) or ``"L"`` (``(H, W)``),
uint8 and C-contiguous, without PIL: a decoder written after
libjpeg-turbo's (islow IDCT, fancy upsampling, YCbCr and YCCK tables,
Huffman and arithmetic entropy decoding, progressive block smoothing,
lossless prediction; see the source's head). An ``"L"`` request on a
colour file is PIL's integer luma of the RGB decode, never the file's Y
channel; a CMYK or YCCK file is read as PIL reads it (inverted CMYK, then
Pillow's CMYK -> RGB).

It takes every 8-bit JPEG that PIL decodes: sequential and progressive
Huffman (SOF0-2), lossless Huffman (SOF3), sequential and progressive
arithmetic coding (SOF9, SOF10, with DAC conditioning), 1, 3 or 4
components, restart markers, a Motion-JPEG frame without DHT (the standard
tables). Baseline files stream block by block; the others fill a
coefficient store first. What PIL refuses raises ``ValueError`` naming the
file and the cause: hierarchical files (SOF5-7, SOF13-15), lossless
arithmetic (SOF11), a lossless YCbCr or YCCK file (libjpeg makes no colour
conversion there), precision other than 8 bits, 2 components, a truncated
file, anything that is not a JPEG. One file PIL refuses is decoded: an
arithmetic-coded file larger than PIL's 64 KiB read block (PIL's source
manager suspends, libjpeg's arithmetic decoder cannot), to the pixels of
its baseline original. A file that cannot be read raises ``OSError``
(``FileNotFoundError`` ...), as PIL's ``open`` does. Nothing falls back to
PIL or to a grey frame.

It is the JPEG half of the frame decoder's library (``data/image.py``,
which builds and loads it): :func:`decode_jpeg` reads JPEGs only, where
:func:`~.image.decode_image` sniffs the format first. Each decode adds one
to the JPEG counter, ``DECODES["jpeg"]`` (``kernels.launch_counts()``
lists it as ``host_jpeg_decode``), whichever of the two made it.
"""

from __future__ import annotations

import numpy as np

from .image import DECODES, decode_with


def decode_jpeg(path: str, mode: str = "RGB") -> np.ndarray:
    """The pixels of the JPEG at ``path`` as PIL's ``convert(mode)`` gives
    them: ``(H, W, 3)`` for ``"RGB"``, ``(H, W)`` for ``"L"``, uint8. One
    library call reads and decodes the file, the GIL released."""
    return decode_with("adt_jpeg_decode_file", path, mode, DECODES["jpeg"])
