"""The port's decoder of PNG, BMP and PNM frames (``data/image.py``,
``csrc/image_decode.cpp``) against PIL on the CPU, exactly (max |d| 0):

* every committed fixture (``tests/fixtures/torch_port_frames``, written
  by :func:`write_fixtures` with :mod:`tests.frame_encoders` and PIL's
  own writers) decodes as RGB and as L to PIL's bytes, and to the digests
  PIL 12.1.0 gave (``digests.json``), which PIL still gives: PNG colour
  types 0, 2, 3, 4 and 6 at every depth, the five filters, Adam7, PLTE
  (short, with indices past its end) and tRNS, IDAT split over chunks,
  stored, fixed and dynamic deflate blocks, ancillary chunks; BMP at 1, 4,
  8, 16, 24 and 32 bits, RLE8 and RLE4 (with the runs Pillow clips, odd
  RLE4 absolute runs and Pillow's delta), every BI_BITFIELDS layout PIL
  takes, top-down rows, the OS/2 core header and the 40- to 124-byte
  headers, a headerless DIB, grey palettes; PNM P1-P6 at maxvals 1 to
  65535 with comments; and a PNG, a BMP and a PPM saved under a ``.jpg``
  name;
* the formats PIL opens that the port does not (GIF, TIFF, WebP, AVIF,
  JPEG 2000, QOI, ICO, TGA, all written by PIL) raise ``ValueError``
  naming the file and the format; truncated files, a bad CRC, a bad
  Adler-32, a corrupt deflate stream, one that inflates past the image
  and an image of more pixels than PIL opens raise ``ValueError``; an
  unreadable file ``OSError``; ``decode_jpeg`` still refuses a PNG;
* each decode counts once under its format
  (``kernels.launch_counts()``: ``host_png_decode`` ...);
* the port's ``DirectoryFrameProvider`` on PNG, BMP and PPM frame
  directories equals the JAX package's (PIL);
* six threads decoding at once give the serial decode.

``python -m tests.test_torch_port_frame_formats`` writes the fixtures and
their digests anew.
"""

import hashlib
import io
import json
import os
import struct
import threading
import zlib

import numpy as np
import pytest
from PIL import Image

from action_detection_tpu.data.pipeline import (
    DirectoryFrameProvider as JDirectoryFrameProvider)

from action_detection_torch.data.image import decode_image
from action_detection_torch.data.jpeg import decode_jpeg
from action_detection_torch.data.pipeline import DirectoryFrameProvider
from action_detection_torch.kernels import launch_counts, reset_launch_counts

from tests.frame_encoders import (bmp_bytes, png_bytes, png_chunk, png_rgb,
                                  pnm_bytes, ppm_rgb, rle_stream)
from tests.test_torch_port_jpeg import pil_decode, scene

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_port_frames")
JPEG_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "fixtures", "torch_port_jpeg")


def _rng(seed):
    return np.random.RandomState(seed)


def _grey_png(depth, interlace=False, size=(7, 13), **kw):
    def make(seed):
        h, w = size
        v = _rng(seed).randint(0, 1 << depth, (h, w))
        if depth == 16:     # values past 255, which convert clips
            v[0, :4] = [0, 255, 256, 65535]
        return png_bytes(v, depth, 0, interlace=interlace, **kw)
    return make


def _colour_png(depth, ctype, interlace=False, size=(7, 13), **kw):
    def make(seed):
        h, w = size
        n = {2: 3, 4: 2, 6: 4}[ctype]
        return png_bytes(_rng(seed).randint(0, 1 << depth, (h, w, n)),
                         depth, ctype, interlace=interlace, **kw)
    return make


def _palette_png(depth, entries, interlace=False, trns=None, size=(7, 13)):
    """Indices over every value the depth holds: those past the PLTE's
    ``entries`` are black under PIL."""
    def make(seed):
        rng = _rng(seed)
        h, w = size
        pal = rng.randint(0, 256, (entries, 3))
        return png_bytes(rng.randint(0, 1 << depth, (h, w)), depth, 3,
                         palette=pal, trns=trns, interlace=interlace,
                         filters=(0, 1, 2, 3, 4))
    return make


def _scene_png(noise=6.0, **kw):
    def make(seed):
        return png_bytes(scene(24, 37, 3, seed, noise=noise), 8, 2, **kw)
    return make


def _pil_save(mode, fmt, size=(9, 14), **save):
    """A file PIL itself writes from a scene (``mode`` "1", "L", "P" or
    "RGB")."""
    def make(seed):
        h, w = size
        img = Image.fromarray(scene(h, w, 3, seed))
        img = (img.convert(mode) if mode != "P"
               else img.convert("P", palette=Image.Palette.ADAPTIVE))
        buf = io.BytesIO()
        img.save(buf, fmt, **save)
        return buf.getvalue()
    return make


def _bmp_indexed(bits, colors=0, grey=False, size=(7, 13), **kw):
    def make(seed):
        rng = _rng(seed)
        h, w = size
        n = colors or (1 << bits)
        pal = (np.repeat(np.arange(n)[:, None], 3, 1) if grey
               else rng.randint(0, 256, (n, 3)))
        if grey and n == 2:
            pal = np.array([[0] * 3, [255] * 3])
        idx = rng.randint(0, 1 << bits, (h, w))
        return bmp_bytes(idx, bits, palette=pal, colors=colors, **kw)
    return make


def _bmp_rgb(bits, size=(7, 13), **kw):
    def make(seed):
        h, w = size
        if bits == 16:
            px = _rng(seed).randint(0, 65536, (h, w))
        else:
            px = scene(h, w, 3, seed)
        return bmp_bytes(px, bits, **kw)
    return make


def _bmp_rle(rle4, grey=False, size=(9, 15)):
    def make(seed):
        rng = _rng(seed)
        h, w = size
        n = 16 if rle4 else 256
        pal = (np.repeat(np.arange(n)[:, None], 3, 1) if grey
               else rng.randint(0, 256, (n, 3)))
        idx = rng.randint(0, n, (h, w))
        idx[:, 3:6] = idx[:, 3:4]   # runs
        return bmp_bytes(idx, 4 if rle4 else 8, palette=pal,
                         compression=2 if rle4 else 1,
                         data=rle_stream(idx, rle4, seed))
    return make


#: the 32-bit BI_BITFIELDS layouts PIL supports: (R, G, B, A) masks, and
#: the byte of R, G, B in a pixel
BITFIELDS32 = {
    "bgrx": ((0xFF0000, 0xFF00, 0xFF, 0), (2, 1, 0)),
    "xbgr": ((0xFF000000, 0xFF0000, 0xFF00, 0), (3, 2, 1)),
    "bgxr": ((0xFF000000, 0xFF00, 0xFF, 0), (3, 1, 0)),
    "abgr": ((0xFF000000, 0xFF0000, 0xFF00, 0xFF), (3, 2, 1)),
    "rgba": ((0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0, 1, 2)),
    "bgra": ((0xFF0000, 0xFF00, 0xFF, 0xFF000000), (2, 1, 0)),
    "bgar": ((0xFF000000, 0xFF00, 0xFF, 0xFF0000), (3, 1, 0)),
    "zero": ((0, 0, 0, 0), (2, 1, 0)),
}


def _pnm(kind, maxval=255, comment=False, size=(5, 11)):
    def make(seed):
        h, w = size
        top = 2 if kind in (1, 4) else maxval + 1
        shape = (h, w, 3) if kind in (3, 6) else (h, w)
        v = _rng(seed).randint(0, top, shape)
        return pnm_bytes(v, kind, maxval, comment)
    return make


def _png_variants():
    f = {}
    for d in (1, 2, 4, 8, 16):
        f[f"png_grey{d}.png"] = _grey_png(d, filters=(0, 1, 2, 3, 4))
        f[f"png_grey{d}_adam7.png"] = _grey_png(d, True, size=(11, 19),
                                                filters=(4, 3, 1))
    for d in (8, 16):
        for ctype, name in ((2, "rgb"), (4, "la"), (6, "rgba")):
            f[f"png_{name}{d}.png"] = _colour_png(d, ctype,
                                                  filters=(0, 1, 2, 3, 4))
            f[f"png_{name}{d}_adam7.png"] = _colour_png(
                d, ctype, True, size=(10, 17), filters=(1, 4, 2))
    for d, entries in ((1, 2), (2, 3), (4, 9), (8, 200)):
        f[f"png_palette{d}.png"] = _palette_png(d, entries)
    f["png_palette8_trns.png"] = _palette_png(8, 256, trns=bytes(range(0, 256, 3)))
    f["png_palette4_trns_simple_adam7.png"] = _palette_png(
        4, 16, True, trns=b"\xff\xff\x00\xff")
    f["png_grey8_trns.png"] = _grey_png(8, trns=b"\x00\x07")
    f["png_rgb8_trns.png"] = _colour_png(8, 2, trns=b"\x00\x01\x00\x02\x00\x03")
    f["png_grey1_trns.png"] = _grey_png(1, trns=b"\x00\x01")
    # tiny images: Adam7 passes that hold no pixel
    for h, w in ((1, 1), (2, 3), (5, 1)):
        f[f"png_rgb8_{h}x{w}_adam7.png"] = _colour_png(
            8, 2, True, size=(h, w), filters=(4,))
    # deflate: stored blocks, fixed Huffman codes, Huffman only, RLE; the
    # stream cut into IDATs of 7 bytes; ancillary chunks around the data
    f["png_stored.png"] = _scene_png(level=0, filters=(0, 2))
    # (a smooth scene: zlib stores noise it cannot shrink)
    f["png_fixed.png"] = _scene_png(0.0, strategy=zlib.Z_FIXED, filters=(1,))
    f["png_huffman_only.png"] = _scene_png(strategy=zlib.Z_HUFFMAN_ONLY,
                                           filters=(4,))
    f["png_rle.png"] = _scene_png(strategy=zlib.Z_RLE, filters=(3, 0))
    f["png_idat7.png"] = _scene_png(idat_chunk=7, filters=(0, 1, 2, 3, 4))
    f["png_ancillary.png"] = _scene_png(
        before=[png_chunk(b"gAMA", struct.pack(">I", 45455)),
                png_chunk(b"tEXt", b"Comment\x00a frame")],
        after=[png_chunk(b"tEXt", b"Software\x00tests")])
    f["png_best_filter.png"] = lambda seed: png_rgb(scene(19, 23, 3, seed))
    f["png_pil_rgb.png"] = _pil_save("RGB", "PNG")
    f["png_pil_l.png"] = _pil_save("L", "PNG")
    f["png_pil_p.png"] = _pil_save("P", "PNG")
    f["png_pil_1.png"] = _pil_save("1", "PNG")
    return f


def _bmp_variants():
    f = {}
    f["bmp_1.bmp"] = _bmp_indexed(1)
    f["bmp_1_grey.bmp"] = _bmp_indexed(1, grey=True)
    f["bmp_4.bmp"] = _bmp_indexed(4)
    f["bmp_4_colors5.bmp"] = _bmp_indexed(4, colors=5)
    f["bmp_8.bmp"] = _bmp_indexed(8)
    f["bmp_8_colors37.bmp"] = _bmp_indexed(8, colors=37)
    f["bmp_8_grey.bmp"] = _bmp_indexed(8, grey=True)
    f["bmp_8_topdown.bmp"] = _bmp_indexed(8, top_down=True)
    f["bmp_16_555.bmp"] = _bmp_rgb(16, size=(30, 41))
    f["bmp_16_bitfields_565.bmp"] = _bmp_rgb(
        16, size=(30, 41), compression=3, masks=(0xF800, 0x7E0, 0x1F))
    f["bmp_16_bitfields_555.bmp"] = _bmp_rgb(
        16, compression=3, masks=(0x7C00, 0x3E0, 0x1F))
    f["bmp_24.bmp"] = _bmp_rgb(24)
    f["bmp_24_topdown.bmp"] = _bmp_rgb(24, top_down=True)
    f["bmp_24_bitfields.bmp"] = _bmp_rgb(
        24, compression=3, masks=(0xFF0000, 0xFF00, 0xFF))
    f["bmp_32.bmp"] = _bmp_rgb(32)
    for name, (masks, pos) in BITFIELDS32.items():
        f[f"bmp_32_bitfields_{name}.bmp"] = _bmp_rgb(
            32, compression=3, masks=masks, positions=pos,
            header=56 if masks[3] else 40)
    f["bmp_core_24.bmp"] = _bmp_rgb(24, header=12)
    f["bmp_core_8.bmp"] = _bmp_indexed(8, header=12)
    for hs in (52, 56, 64, 108, 124):
        f[f"bmp_header{hs}_24.bmp"] = _bmp_rgb(24, header=hs)
    f["bmp_header124_8_topdown.bmp"] = _bmp_indexed(8, header=124,
                                                    top_down=True)
    f["bmp_rle8.bmp"] = _bmp_rle(False)
    f["bmp_rle8_grey.bmp"] = _bmp_rle(False, grey=True)
    f["bmp_rle4.bmp"] = _bmp_rle(True)
    f["bmp_rle4_grey.bmp"] = _bmp_rle(True, grey=True)
    f["dib_24.dib"] = _bmp_rgb(24, file_header=False)
    f["dib_8.dib"] = _bmp_indexed(8, file_header=False)
    f["dib_bitfields_565.dib"] = _bmp_rgb(
        16, file_header=False, compression=3, masks=(0xF800, 0x7E0, 0x1F))
    f["bmp_pil_rgb.bmp"] = _pil_save("RGB", "BMP")
    f["bmp_pil_l.bmp"] = _pil_save("L", "BMP")
    f["bmp_pil_p.bmp"] = _pil_save("P", "BMP")
    f["bmp_pil_1.bmp"] = _pil_save("1", "BMP")
    return f


def _pnm_variants():
    f = {}
    f["pnm_p1.pbm"] = _pnm(1, comment=True)
    f["pnm_p4.pbm"] = _pnm(4)
    for kind in (2, 3, 5, 6):
        for maxval in (1, 100, 255, 1000, 65535):
            f[f"pnm_p{kind}_max{maxval}.p{kind}"] = _pnm(
                kind, maxval, comment=maxval == 100)
    f["pnm_pil_rgb.ppm"] = _pil_save("RGB", "PPM")
    f["pnm_pil_l.pgm"] = _pil_save("L", "PPM")
    f["pnm_pil_1.pbm"] = _pil_save("1", "PPM")
    return f


#: every committed fixture: name -> writer(seed) -> bytes
FIXTURE_WRITERS = {**_png_variants(), **_bmp_variants(), **_pnm_variants()}
# a PNG, a BMP and a PPM under the CLIs' frame name: PIL sniffs the bytes
FIXTURE_WRITERS.update({
    "png_as_img_00001.jpg": _scene_png(filters=(4,)),
    "bmp_as_img_00001.jpg": _bmp_rgb(24, size=(24, 37)),
    "ppm_as_img_00001.jpg": lambda seed: ppm_rgb(scene(24, 37, 3, seed)),
})
FIXTURE_NAMES = sorted(FIXTURE_WRITERS)


def _digest(a: np.ndarray) -> dict:
    return {"shape": list(a.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes())
            .hexdigest()}


def write_fixtures(directory: str = FIXTURES) -> None:
    """The committed fixtures (each from its writer, seeded by its index)
    and ``digests.json``: the shape and sha256 of PIL's ``convert("RGB")``
    and ``convert("L")`` of each."""
    os.makedirs(directory, exist_ok=True)
    digests = {}
    for seed, name in enumerate(FIXTURE_NAMES):
        path = os.path.join(directory, name)
        with open(path, "wb") as f:
            f.write(FIXTURE_WRITERS[name](seed))
        digests[name] = {mode: _digest(pil_decode(path, mode))
                         for mode in ("RGB", "L")}
    with open(os.path.join(directory, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


def _digests() -> dict:
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("name", FIXTURE_NAMES)
def test_fixture_decodes_to_pils_bytes(name, mode):
    """The decode of each committed fixture equals PIL's, byte for byte,
    and the digest PIL 12.1.0 gave when the fixture was written."""
    path = os.path.join(FIXTURES, name)
    got = decode_image(path, mode)
    assert got.dtype == np.uint8 and got.flags.c_contiguous
    np.testing.assert_array_equal(got, pil_decode(path, mode))
    assert _digest(got) == _digests()[name][mode]


def test_committed_fixtures_match_their_digests_under_pil():
    """PIL still decodes the committed files to ``digests.json`` (a Pillow
    that decodes them otherwise shows here first), and every fixture the
    writers name is committed."""
    digests = _digests()
    assert sorted(digests) == FIXTURE_NAMES
    for name, modes in digests.items():
        for mode, want in modes.items():
            assert _digest(pil_decode(os.path.join(FIXTURES, name),
                                      mode)) == want, (name, mode)


def test_fixtures_stay_small():
    sizes = [os.path.getsize(os.path.join(FIXTURES, n))
             for n in FIXTURE_NAMES]
    assert max(sizes) < 8192 and sum(sizes) < 1 << 20, (max(sizes),
                                                        sum(sizes))


def test_writers_make_the_committed_fixtures():
    """The writers give the committed bytes again (the PIL-written files
    aside, whose bytes follow Pillow's writers and zlib's)."""
    for seed, name in enumerate(FIXTURE_NAMES):
        if "_pil_" in name or not name.startswith(("bmp", "dib", "pnm")):
            continue
        with open(os.path.join(FIXTURES, name), "rb") as f:
            assert f.read() == FIXTURE_WRITERS[name](seed), name


def _pil_writes(fmt, **save):
    def write(path):
        Image.fromarray(scene(32, 32, 3, 7)).save(path, fmt, **save)
    return write


def _magic(data):
    def write(path):
        with open(path, "wb") as f:
            f.write(data)
    return write


#: formats PIL opens and the port does not: the writer, the name the
#: refusal must carry
REFUSED = {
    "gif": (_pil_writes("GIF"), "GIF"),
    "tiff": (_pil_writes("TIFF"), "TIFF"),
    "webp": (_pil_writes("WEBP"), "WebP"),
    "webp_lossless": (_pil_writes("WEBP", lossless=True), "WebP"),
    "avif": (_pil_writes("AVIF"), "AVIF"),
    "jpeg2000": (_pil_writes("JPEG2000"), "JPEG 2000"),
    "qoi": (_pil_writes("QOI"), "QOI"),
    "ico": (_pil_writes("ICO"), "ICO"),
    "tga": (_pil_writes("TGA"), "TGA"),
    "pfm": (_magic(b"Pf\n2 2\n-1.0\n" + bytes(16)), "PFM"),
    "psd": (_magic(b"8BPS" + bytes(40)), "PSD"),
    "unknown": (_magic(b"\x00\x11 not an image at all"), "not an image"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_other_formats_raise_naming_the_format(tmp_path, case):
    """A file of another format, under the CLIs' ``.jpg`` name, raises
    ValueError naming the file, its format and the formats the port
    decodes; no grey frame comes back."""
    write, name = REFUSED[case]
    path = str(tmp_path / "img_00001.jpg")
    write(path)
    for mode in ("RGB", "L"):
        with pytest.raises(ValueError) as e:
            decode_image(path, mode)
        msg = str(e.value)
        assert path in msg and name in msg, msg
        assert "JPEG, PNG, BMP and PNM" in msg, msg


def _fixture_bytes(name):
    with open(os.path.join(FIXTURES, name), "rb") as f:
        return f.read()


def _corrupt(name, edit):
    def write(path):
        data = bytearray(_fixture_bytes(name))
        edit(data)
        with open(path, "wb") as f:
            f.write(bytes(data))
    return write


def _cut(name, keep):
    return _corrupt(name, lambda d: d.__delitem__(slice(keep, None)))


def _flip(name, at):
    def edit(d):
        d[at] ^= 0x40
    return _corrupt(name, edit)


def _png_idat_edit(name, edit, fix_crc):
    """Edit the zlib stream of a one-IDAT PNG (and its CRC, or not)."""
    def write(path):
        data = bytearray(_fixture_bytes(name))
        i = data.index(b"IDAT")
        n = struct.unpack(">I", data[i - 4:i])[0]
        body = bytearray(data[i + 4:i + 4 + n])
        edit(body)
        crc = zlib.crc32(b"IDAT" + body) & 0xFFFFFFFF
        if not fix_crc:
            crc ^= 1
        data[i + 4:i + 8 + n] = bytes(body) + struct.pack(">I", crc)
        with open(path, "wb") as f:
            f.write(bytes(data))
    return write


def _last(k):
    def edit(body):
        body[-k] ^= 0x01
    return edit


def _png_raw(w, h, raw):
    """A grey 8-bit PNG of any ``raw`` (filter bytes and rows) stream."""
    return _magic(b"\x89PNG\r\n\x1a\n" + png_chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, 0, 0, 0, 0)) + png_chunk(
        b"IDAT", zlib.compress(raw)) + png_chunk(b"IEND", b""))


#: damaged files: the writer and what the message says
DAMAGED = {
    # a 1x1 image whose stream inflates to 1 MiB: refused, not inflated
    "png_inflates_past_the_image": (_png_raw(1, 1, bytes(1 << 20)),
                                    "more than the image"),
    # more pixels than PIL opens (its DecompressionBombError)
    "png_too_many_pixels": (_png_raw(20000, 20000, bytes(16)), "pixels"),
    "png_cut_in_idat": (_cut("png_rgb8.png", 120), "truncated"),
    "png_cut_before_iend": (_cut("png_rgb8.png", -6), "truncated"),
    "png_bad_ihdr_crc": (_flip("png_rgb8.png", 29), "CRC"),
    "png_bad_idat_crc": (_png_idat_edit("png_rgb8.png", lambda b: None,
                                        False), "CRC"),
    "png_bad_adler": (_png_idat_edit("png_rgb8.png", _last(1), True),
                      "Adler-32"),
    "png_corrupt_deflate": (_png_idat_edit(
        "png_rgb8.png", lambda b: b.__setitem__(2, b[2] | 6), True),
        "deflate"),
    "png_header_only": (_cut("png_rgb8.png", 8), "truncated"),
    "bmp_cut_pixels": (_cut("bmp_24.bmp", -40), "truncated"),
    "bmp_cut_rle": (_cut("bmp_rle8.bmp", 1078 + 20), "truncated"),
    "bmp_bad_bitfields": (_corrupt("bmp_16_bitfields_565.bmp",
                                   lambda d: d.__setitem__(54, 0x12)),
                          "bitfields"),
    "bmp_bad_depth": (_corrupt("bmp_24.bmp",
                               lambda d: d.__setitem__(28, 7)), "depth"),
    "pnm_cut_raw": (_cut("pnm_p6_max255.p6", -3), "truncated"),
    "pnm_cut_plain": (_cut("pnm_p2_max1000.p2", -40), "truncated"),
    "pnm_cut_header": (_cut("pnm_p5_max255.p5", 5), "EOF"),
}


@pytest.mark.parametrize("case", sorted(DAMAGED))
def test_damaged_files_raise_valueerror(tmp_path, case):
    write, what = DAMAGED[case]
    path = str(tmp_path / f"{case}.jpg")
    write(path)
    with pytest.raises(ValueError, match=what) as e:
        decode_image(path, "RGB")
    assert path in str(e.value)


def test_unreadable_file_raises_oserror(tmp_path):
    with pytest.raises(FileNotFoundError, match="no_such_frame"):
        decode_image(str(tmp_path / "no_such_frame.png"))
    with pytest.raises(IsADirectoryError):
        decode_image(str(tmp_path), "L")


def test_decode_jpeg_still_refuses_other_formats():
    """``decode_jpeg`` keeps its behaviour: a PNG is not a JPEG to it."""
    with pytest.raises(ValueError, match="no SOI marker"):
        decode_jpeg(os.path.join(FIXTURES, "png_as_img_00001.jpg"))
    np.testing.assert_array_equal(
        decode_image(os.path.join(JPEG_FIXTURES, "img_00001.jpg")),
        decode_jpeg(os.path.join(JPEG_FIXTURES, "img_00001.jpg")))


def test_each_decode_counts_under_its_format():
    reset_launch_counts()
    for name in ("png_rgb8.png", "png_as_img_00001.jpg", "bmp_24.bmp",
                 "dib_8.dib", "pnm_p6_max255.p6", "pnm_p1.pbm"):
        decode_image(os.path.join(FIXTURES, name), "L")
    decode_image(os.path.join(JPEG_FIXTURES, "img_00001.jpg"))
    decode_jpeg(os.path.join(JPEG_FIXTURES, "img_00001.jpg"))
    counts = launch_counts()
    assert {k: counts[k] for k in ("host_png_decode", "host_bmp_decode",
                                   "host_pnm_decode", "host_jpeg_decode")
            } == {"host_png_decode": 2, "host_bmp_decode": 2,
                  "host_pnm_decode": 2, "host_jpeg_decode": 2}
    reset_launch_counts()
    assert not any(launch_counts()[k] for k in counts if "decode" in k)


def write_frame_directory(root: str, video: str, n: int) -> None:
    """``root/video`` with ``img_``, ``x_`` and ``y_`` frames 1..n under
    their ``.jpg`` names holding, in turn, a filtered PNG, an Adam7 PNG, a
    BMP and a PPM (PGM for Flow) of the committed JPEG frames' pixels."""
    d = os.path.join(root, video)
    os.makedirs(d)
    for i in range(1, n + 1):
        k = (i - 1) % 8 + 1
        rgb = decode_jpeg(os.path.join(JPEG_FIXTURES, f"img_{k:05d}.jpg"))
        grey = [decode_jpeg(os.path.join(JPEG_FIXTURES, f"{a}_{k:05d}.jpg"),
                            "L") for a in "xy"]
        fmt = (i - 1) % 4
        enc = [lambda a: png_rgb(a) if a.ndim == 3
               else png_bytes(a, 8, 0, filters=(4, 1)),
               lambda a: png_bytes(a, 8, 2 if a.ndim == 3 else 0,
                                   interlace=True, filters=(2,)),
               lambda a: bmp_bytes(a, 24) if a.ndim == 3 else bmp_bytes(
                   a, 8, palette=np.repeat(np.arange(256)[:, None], 3, 1)),
               lambda a: pnm_bytes(a, 6 if a.ndim == 3 else 5)][fmt]
        for name, a in ((f"img_{i:05d}.jpg", rgb), (f"x_{i:05d}.jpg",
                                                    grey[0]),
                        (f"y_{i:05d}.jpg", grey[1])):
            with open(os.path.join(d, name), "wb") as f:
                f.write(enc(a))


@pytest.mark.parametrize("modality", ["RGB", "Flow"])
def test_directory_provider_matches_jax_on_lossless_frames(tmp_path,
                                                           modality):
    """The port's DirectoryFrameProvider and the JAX package's (PIL) load
    the same arrays from PNG, BMP and PPM/PGM frames named ``*.jpg``: the
    pixels of the JPEG frames they were written from."""
    write_frame_directory(str(tmp_path), "video_0", 4)
    tmpl = "img_{:05d}.jpg" if modality == "RGB" else "{}_{:05d}.jpg"
    port = DirectoryFrameProvider(str(tmp_path), tmpl, modality)
    ref = JDirectoryFrameProvider(str(tmp_path), tmpl, modality)
    reset_launch_counts()
    for idx in range(1, 5):
        got, want = port.load("video_0", idx), ref.load("video_0", idx)
        assert len(got) == len(want) == (2 if modality == "Flow" else 1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))
        jpeg_name = (f"img_{idx:05d}.jpg" if modality == "RGB"
                     else f"x_{idx:05d}.jpg")
        np.testing.assert_array_equal(got[0], decode_jpeg(
            os.path.join(JPEG_FIXTURES, jpeg_name),
            "RGB" if modality == "RGB" else "L"))
    per = 1 if modality == "RGB" else 2
    counts = launch_counts()
    assert (counts["host_png_decode"], counts["host_bmp_decode"],
            counts["host_pnm_decode"]) == (2 * per, per, per)


def test_threads_decode_as_one():
    jobs = [(os.path.join(FIXTURES, n), m) for n in FIXTURE_NAMES
            for m in ("RGB", "L")]
    serial = [decode_image(p, m) for p, m in jobs]
    got = [None] * len(jobs)
    barrier = threading.Barrier(6)

    def work(t):
        barrier.wait()
        for i in range(t, len(jobs), 6):
            got[i] = decode_image(*jobs[i])

    threads = [threading.Thread(target=work, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(got, serial):
        np.testing.assert_array_equal(a, b)


if __name__ == "__main__":
    write_fixtures()
