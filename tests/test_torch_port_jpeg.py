"""The port's JPEG decoder (``data/jpeg.py``, ``csrc/jpeg_decode.cpp``)
against PIL on the CPU, exactly (max |d| 0):

* one parametrised test over the files PIL writes (4:2:0, 4:2:2, 4:4:4,
  grayscale, ``optimize``, restart markers, qualities 30-95, odd sizes
  down to 1x1) and the structures it cannot write, from this module's
  baseline encoder (:func:`encode_baseline`: 4:4:0, 4:1:1, 3:1 and mixed
  sampling, non-interleaved scans, Adobe RGB, 'R','G','B' component ids,
  16-bit quantization tables, codes of 3 to 16 bits), each decoded as RGB
  and as L; a progressive file is refused by name;
* a colour file read as L (PIL's luma, not the file's Y), a grayscale file
  read as RGB;
* truncated, empty, non-JPEG and CMYK files raise ``ValueError`` naming
  the file;
* six threads decoding at once give the serial decode;
* the committed fixtures (``tests/fixtures/torch_port_jpeg``, written by
  :func:`write_fixtures`) still decode under PIL to ``digests.json``, and
  under the port's decoder too;
* the port's ``DirectoryFrameProvider`` against the JAX package's, for
  RGB, Flow and RGBDiff, exactly;
* the decoder's own library, its build failure and its launch counter.

``python -m tests.test_torch_port_jpeg`` writes the fixtures anew.
"""

import hashlib
import json
import os
import threading

import numpy as np
import pytest
from PIL import Image

from action_detection_tpu.data.pipeline import (
    DirectoryFrameProvider as JDirectoryFrameProvider)

from action_detection_torch.data import jpeg
from action_detection_torch.data.jpeg import decode_jpeg
from action_detection_torch.data.pipeline import (DirectoryFrameProvider,
                                                  frame_template)
from action_detection_torch.kernels import launch_counts, reset_launch_counts

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures", "torch_port_jpeg")
N_FIXTURE_FRAMES = 8
RGB_FIXTURES = [f"img_{i:05d}.jpg" for i in range(1, N_FIXTURE_FRAMES + 1)]
FLOW_FIXTURES = [f"{a}_{i:05d}.jpg" for i in range(1, N_FIXTURE_FRAMES + 1)
                 for a in "xy"]
COLOUR_FIXTURES = ["colour_452x341.jpg", "colour_341x257.jpg"]


def scene(h: int, w: int, channels: int, seed: int, amplitude=80.0,
          noise=6.0) -> np.ndarray:
    """A smooth scene (sums of sines) with Gaussian noise, uint8."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    planes = []
    for _ in range(channels):
        f = rng.uniform(0.01, 0.06, 4)
        p = rng.uniform(0, 2 * np.pi, 4)
        planes.append(128 + amplitude * (
            0.6 * np.sin(x * f[0] + p[0]) * np.cos(y * f[1] + p[1])
            + 0.4 * np.sin((x + y) * f[2] + p[2]) * np.sin(x * f[3] + p[3]))
            + rng.randn(h, w) * noise)
    a = np.clip(np.rint(np.stack(planes, -1)), 0, 255).astype(np.uint8)
    return a if channels > 1 else a[..., 0]


def _digest(a: np.ndarray) -> dict:
    return {"shape": list(a.shape),
            "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes())
            .hexdigest()}


def pil_decode(path: str, mode: str) -> np.ndarray:
    """The plain version: PIL's decode, as the JAX package's provider."""
    with Image.open(path) as img:
        return np.asarray(img.convert(mode))


def load_with_pil(provider, video_id: str, idx: int) -> list:
    """``DirectoryFrameProvider.load`` on PIL's decode: the plain version
    of the port's provider (the port itself imports no PIL)."""
    directory = os.path.join(provider.root, video_id)
    if provider.modality in ("RGB", "RGBDiff"):
        return [pil_decode(os.path.join(
            directory, provider.image_tmpl.format(idx)), "RGB")]
    return [pil_decode(os.path.join(
        directory, provider.image_tmpl.format(axis, idx)), "L")
        for axis in ("x", "y")]


def write_fixtures(directory: str = FIXTURES) -> None:
    """The committed frames: 8 RGB frames at 340x256 (quality 90, 4:2:0,
    as frame extractors write them), 8 Flow x/y pairs (grayscale, quality
    90, smooth fields about 128), a 452x341 frame (4:2:0, quality 95) and
    a 341x257 one (4:4:4, quality 75); and ``digests.json``: the sha256
    and shape of PIL's ``convert("RGB")`` and ``convert("L")`` of each."""
    os.makedirs(directory, exist_ok=True)
    for i, name in enumerate(RGB_FIXTURES):
        Image.fromarray(scene(256, 340, 3, seed=i)).save(
            os.path.join(directory, name), quality=90)
    for i, name in enumerate(FLOW_FIXTURES):
        Image.fromarray(scene(256, 340, 1, seed=100 + i, amplitude=40,
                              noise=3)).save(os.path.join(directory, name),
                                             quality=90)
    Image.fromarray(scene(341, 452, 3, seed=200)).save(
        os.path.join(directory, COLOUR_FIXTURES[0]), quality=95)
    Image.fromarray(scene(257, 341, 3, seed=201)).save(
        os.path.join(directory, COLOUR_FIXTURES[1]), quality=75,
        subsampling="4:4:4")
    digests = {name: {mode: _digest(pil_decode(os.path.join(directory, name),
                                               mode))
                      for mode in ("RGB", "L")}
               for name in RGB_FIXTURES + FLOW_FIXTURES + COLOUR_FIXTURES}
    with open(os.path.join(directory, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


def link_frames(root: str, video: str, n_frames: int, modality: str) -> str:
    """``root/video`` holding frames 1..n_frames of ``modality`` (the
    CLIs' file names, :func:`frame_template`) as links cycling over the
    committed fixtures."""
    d = os.path.join(root, video)
    os.makedirs(d, exist_ok=True)
    tmpl = frame_template(modality)
    for i in range(1, n_frames + 1):
        k = (i - 1) % N_FIXTURE_FRAMES + 1
        if modality == "Flow":
            for a in "xy":
                os.symlink(os.path.join(FIXTURES, f"{a}_{k:05d}.jpg"),
                           os.path.join(d, tmpl.format(a, i)))
        else:
            os.symlink(os.path.join(FIXTURES, f"img_{k:05d}.jpg"),
                       os.path.join(d, tmpl.format(i)))
    return d


# --------------------------------------------------------- a baseline encoder

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
# this encoder's Huffman tables: (code lengths, symbols); DC codes of 3 and
# 5 bits, AC codes of 8, 9 and 16 bits (the decoder's lookahead and its
# bit-by-bit path)
_DC = ([3] * 6 + [5] * 6, list(range(12)))
_AC = ([8] * 100 + [9] * 50 + [16] * 12,
       [0x00, 0xF0] + [(r << 4) | s for r in range(16) for s in range(1, 11)])


def _canonical(lengths, symbols):
    """(BITS counts, {symbol: (code, length)}) of canonical codes."""
    bits = [0] * 17
    for n in lengths:
        bits[n] += 1
    codes, code, k = {}, 0, 0
    for n in range(1, 17):
        for _ in range(bits[n]):
            codes[symbols[k]] = (code, n)
            code += 1
            k += 1
        code <<= 1
    return bits[1:], codes


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc, self.n = 0, 0

    def put(self, value: int, n: int) -> None:
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> None:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def encode_baseline(size, planes, sampling, restart=0, interleaved=True,
                    jfif=True, adobe=None, ids=(1, 2, 3), qt16=False):
    """A sequential Huffman JPEG (SOF0) of an image of ``size`` (H, W) from
    ``planes``: one uint8 array per component at its own downsampled size,
    ``ceil(H * v / vmax) x ceil(W * h / hmax)``, with ``sampling`` (h, v) per
    component; one scan, or one scan per component; an optional restart
    interval, JFIF and Adobe markers (``adobe``: its transform flag) and
    component ids; 8- or 16-bit quantization tables."""
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    H, W = size
    for p, (h, v) in zip(planes, sampling):
        assert p.shape == (-(-H * v // vmax), -(-W * h // hmax))
    u = np.arange(8)
    dct = np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16) / 2
    dct[0] /= np.sqrt(2)
    q = 1 + 2 * (u[:, None] + u[None, :])          # natural order
    if qt16:
        q = q * 37 + 3                               # up to 1,040
    mx_n, my_n = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    dc_bits, dc_codes = _canonical(*_DC)
    ac_bits, ac_codes = _canonical(*_AC)

    def blocks_of(p, h, v):
        """Quantized coefficients (rows, cols, 64) in zigzag order."""
        if interleaved and len(planes) > 1:
            rows, cols = my_n * v * 8, mx_n * h * 8
        else:
            rows, cols = -(-p.shape[0] // 8) * 8, -(-p.shape[1] // 8) * 8
        a = np.pad(p.astype(np.float64) - 128,
                   ((0, rows - p.shape[0]), (0, cols - p.shape[1])),
                   mode="edge")
        b = a.reshape(rows // 8, 8, cols // 8, 8).transpose(0, 2, 1, 3)
        f = np.einsum("ux,rcxy,vy->rcuv", dct, b, dct)
        z = np.rint(f / q).astype(np.int64).reshape(rows // 8, cols // 8, 64)
        return z[..., _ZIGZAG]

    coefs = [blocks_of(p, h, v) for p, (h, v) in zip(planes, sampling)]

    def category(v):
        """(size, amplitude bits) of a coefficient or DC difference."""
        n = int(abs(v)).bit_length()
        return n, (v if v > 0 else v + (1 << n) - 1)

    def put_block(w, z, pred):
        n, bits = category(int(z[0]) - pred)
        w.put(*dc_codes[n])
        if n:
            w.put(bits, n)
        run = 0
        for c in z[1:]:
            if c == 0:
                run += 1
                continue
            while run > 15:
                w.put(*ac_codes[0xF0])
                run -= 16
            n, bits = category(int(c))
            w.put(*ac_codes[(run << 4) | n])
            w.put(bits, n)
            run = 0
        if run:
            w.put(*ac_codes[0x00])
        return int(z[0])

    def scan(comps):
        w = _BitWriter()
        preds = {c: 0 for c in comps}
        if len(comps) > 1:
            units = [[(c, my * sampling[c][1] + by, mx * sampling[c][0] + bx)
                      for c in comps for by in range(sampling[c][1])
                      for bx in range(sampling[c][0])]
                     for my in range(my_n) for mx in range(mx_n)]
        else:
            c = comps[0]
            units = [[(c, r, k)] for r in range(coefs[c].shape[0])
                     for k in range(coefs[c].shape[1])]
        for i, unit in enumerate(units):
            if restart and i and i % restart == 0:
                w.flush()
                w.out += bytes([0xFF, 0xD0 + (i // restart - 1) % 8])
                preds = {c: 0 for c in comps}
            for c, r, k in unit:
                preds[c] = put_block(w, coefs[c][r, k], preds[c])
        w.flush()
        head = bytes([len(comps)]) + b"".join(bytes([ids[c], 0x00])
                                              for c in comps)
        return _segment(0xDA, head + bytes([0, 63, 0])) + bytes(w.out)

    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    if adobe is not None:
        out += _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                        + bytes([adobe]))
    qz = q.reshape(64)[_ZIGZAG]
    out += _segment(0xDB, bytes([0x10 if qt16 else 0x00]) + (
        b"".join(int(v).to_bytes(2, "big") for v in qz) if qt16
        else bytes(int(v) for v in qz)))
    out += _segment(0xC0, bytes([8]) + H.to_bytes(2, "big")
                    + W.to_bytes(2, "big") + bytes([len(planes)])
                    + b"".join(bytes([ids[c], (h << 4) | v, 0])
                               for c, (h, v) in enumerate(sampling)))
    out += _segment(0xC4, bytes([0x00] + dc_bits) + bytes(_DC[1])
                    + bytes([0x10] + ac_bits) + bytes(_AC[1]))
    if restart:
        out += _segment(0xDD, restart.to_bytes(2, "big"))
    comps = list(range(len(planes)))
    for group in ([comps] if interleaved else [[c] for c in comps]):
        out += scan(group)
    return bytes(out) + b"\xff\xd9"


def _planes(size, sampling, seed):
    """One smooth plane per component at its downsampled size."""
    H, W = size
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    return [scene(-(-H * v // vmax), -(-W * h // hmax), 1, seed=seed + c,
                  amplitude=60 if c else 90)
            for c, (h, v) in enumerate(sampling)]


# -------------------------------------------------------------- the cases

def _pil(size, channels=3, **save):
    def write(path, seed):
        Image.fromarray(scene(*size, channels, seed)).save(path, **save)
    return write


def _ours(size, sampling, **enc):
    def write(path, seed):
        with open(path, "wb") as f:
            f.write(encode_baseline(size, _planes(size, sampling, seed),
                                    sampling, **enc))
    return write


S444, S420 = [(1, 1)] * 3, [(2, 2), (1, 1), (1, 1)]
CASES = {
    "420": _pil((256, 340), subsampling="4:2:0", quality=90),
    "422": _pil((256, 340), subsampling="4:2:2", quality=90),
    "444": _pil((256, 340), subsampling="4:4:4", quality=90),
    "grayscale": _pil((256, 340), channels=1, quality=90),
    "optimize": _pil((256, 340), optimize=True, quality=85),
    "restart_blocks": _pil((257, 341), restart_marker_blocks=7, quality=80),
    "restart_rows": _pil((257, 341), restart_marker_rows=1, quality=80),
    "grayscale_restart": _pil((257, 341), channels=1,
                              restart_marker_blocks=3, quality=80),
    "q30": _pil((257, 341), quality=30),
    "q50": _pil((257, 341), quality=50),
    "q75_422": _pil((257, 341), quality=75, subsampling="4:2:2"),
    "q95": _pil((257, 341), quality=95),
    "q100_444": _pil((256, 340), quality=100, subsampling="4:4:4"),
    "odd_341x257_444": _pil((257, 341), quality=85, subsampling="4:4:4"),
    "odd_452x341": _pil((341, 452), quality=90),
    "odd_17x9": _pil((9, 17), quality=90),
    "odd_17x9_422": _pil((9, 17), quality=90, subsampling="4:2:2"),
    "odd_17x9_grayscale": _pil((9, 17), channels=1, quality=90),
    "tiny_3x2": _pil((2, 3), quality=90),
    "tiny_1x1": _pil((1, 1), quality=90),
    "enc_440": _ours((41, 37), [(1, 2), (1, 1), (1, 1)]),
    "enc_411": _ours((23, 45), [(4, 1), (1, 1), (1, 1)]),
    "enc_h3v1": _ours((16, 40), [(3, 1), (1, 1), (1, 1)]),
    "enc_mixed": _ours((35, 29), [(2, 2), (2, 1), (1, 2)]),
    "enc_420_tiny_3x5": _ours((5, 3), S420),
    "enc_non_interleaved_420": _ours((41, 37), S420, interleaved=False),
    "enc_non_interleaved_restart": _ours((41, 37), S420, interleaved=False,
                                         restart=2),
    "enc_interleaved_restart_1": _ours((41, 37), S420, restart=1),
    "enc_adobe_rgb": _ours((19, 27), S444, jfif=False, adobe=0),
    "enc_adobe_ycc": _ours((19, 27), S420, jfif=False, adobe=1),
    "enc_rgb_ids": _ours((19, 27), S444, jfif=False, ids=(82, 71, 66)),
    "enc_unmarked_ycc": _ours((19, 27), S420, jfif=False),
    "enc_grayscale_h2v2": _ours((21, 13), [(2, 2)]),
    "enc_dqt16": _ours((33, 47), S420, qt16=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_decoder_equals_pil(tmp_path, case):
    """RGB and L, each exactly PIL's ``convert`` of the file."""
    path = str(tmp_path / f"{case}.jpg")
    CASES[case](path, seed=len(case))
    for mode in ("RGB", "L"):
        got, want = decode_jpeg(path, mode), pil_decode(path, mode)
        assert got.dtype == np.uint8 and got.flags.c_contiguous
        assert got.shape == want.shape, (mode, got.shape, want.shape)
        assert int(np.abs(got.astype(np.int16) - want).max()) == 0, mode


def test_colour_as_l_is_pil_luma_and_grayscale_as_rgb_replicates(tmp_path):
    """A colour file read as L is PIL's integer luma of the RGB decode (the
    file's Y plane differs); a grayscale file read as RGB is its gray in
    all three channels."""
    colour = str(tmp_path / "c.jpg")
    _pil((64, 80), quality=90)(colour, seed=3)
    rgb = decode_jpeg(colour, "RGB").astype(np.int64)
    luma = (rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
            + 0x8000) >> 16
    np.testing.assert_array_equal(decode_jpeg(colour, "L"), luma)
    np.testing.assert_array_equal(decode_jpeg(colour, "L"),
                                  pil_decode(colour, "L"))
    gray = str(tmp_path / "g.jpg")
    _pil((64, 80), channels=1, quality=90)(gray, seed=4)
    g = decode_jpeg(gray, "L")
    np.testing.assert_array_equal(decode_jpeg(gray, "RGB"),
                                  np.repeat(g[..., None], 3, -1))
    np.testing.assert_array_equal(decode_jpeg(gray, "RGB"),
                                  pil_decode(gray, "RGB"))


def _cut(n):
    def write(path, seed):
        _pil((64, 80), quality=90)(path, seed)
        with open(path, "rb") as f:
            data = f.read()
        with open(path, "wb") as f:
            f.write(data[:n if n >= 0 else len(data) + n])
    return write


def _raw(data):
    def write(path, seed):
        with open(path, "wb") as f:
            f.write(data)
    return write


@pytest.mark.parametrize("case,match", [
    ("truncated_in_data", "truncated"),
    ("truncated_before_eoi", "truncated"),
    ("truncated_in_header", "truncated"),
    ("empty", "not a JPEG file"),
    ("not_jpeg", "not a JPEG file"),
    ("progressive", r"progressive JPEG \(SOF2, marker 0xFFC2\)"),
    ("cmyk", r"4 components \(SOF0"),
])
def test_refusals_name_the_file(tmp_path, case, match):
    """What PIL would not read as RGB or L, or what this decoder does not
    take, raises ValueError naming the file and the cause; no grey frame
    comes back."""
    write = {
        "truncated_in_data": _cut(-400),
        "truncated_before_eoi": _cut(-2),
        "truncated_in_header": _cut(100),
        "empty": _raw(b""),
        "not_jpeg": _raw(b"\x89PNG\r\n\x1a\n not a jpeg"),
        "progressive": _pil((64, 80), progressive=True, quality=90),
        "cmyk": lambda p, seed: Image.new("CMYK", (16, 8), (1, 2, 3, 4))
        .save(p, quality=90),
    }[case]
    path = str(tmp_path / f"frame_{case}.jpg")
    write(path, seed=5)
    for mode in ("RGB", "L"):
        with pytest.raises(ValueError, match=match) as e:
            decode_jpeg(path, mode)
        assert path in str(e.value)
    if case.startswith(("truncated", "empty", "not_jpeg")):
        with pytest.raises(OSError):     # PIL refuses them too
            pil_decode(path, "RGB")


def test_unreadable_file_raises_oserror(tmp_path):
    """A missing file or a directory raises PIL's OSError subclass."""
    with pytest.raises(FileNotFoundError, match="no_such_frame"):
        decode_jpeg(str(tmp_path / "no_such_frame.jpg"))
    with pytest.raises(IsADirectoryError):
        decode_jpeg(str(tmp_path), "L")


def test_each_file_gets_its_own_shape(tmp_path):
    """Frames of one size after another, a transposed size with the same
    byte count, and a small one: each decode has its file's shape."""
    for i, (h, w) in enumerate([(256, 340), (256, 340), (340, 256),
                                (9, 17), (256, 340)]):
        path = str(tmp_path / f"s{i}.jpg")
        _pil((h, w), quality=90)(path, seed=i)
        for mode in ("RGB", "L"):
            np.testing.assert_array_equal(decode_jpeg(path, mode),
                                          pil_decode(path, mode))


def test_mode_other_than_rgb_or_l_raises(tmp_path):
    with pytest.raises(ValueError, match="'RGBA'"):
        decode_jpeg(os.path.join(FIXTURES, RGB_FIXTURES[0]), "RGBA")


def test_threads_decode_as_one(tmp_path):
    """The fixtures decoded by six threads at once (ctypes releases the
    GIL; the decoder keeps its state per call) equal a serial decode."""
    jobs = [(os.path.join(FIXTURES, n), m) for n in
            RGB_FIXTURES + FLOW_FIXTURES + COLOUR_FIXTURES
            for m in ("RGB", "L")] * 2
    serial = [decode_jpeg(p, m) for p, m in jobs]
    got = [None] * len(jobs)
    barrier = threading.Barrier(6)

    def work(t):
        barrier.wait()
        for i in range(t, len(jobs), 6):
            got[i] = decode_jpeg(*jobs[i])

    threads = [threading.Thread(target=work, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for a, b in zip(got, serial):
        np.testing.assert_array_equal(a, b)


def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


def test_committed_fixtures_match_their_digests_under_pil():
    """``digests.json`` is PIL's decode of the committed files, and every
    committed frame is in it."""
    digests = _digests()
    names = RGB_FIXTURES + FLOW_FIXTURES + COLOUR_FIXTURES
    assert sorted(digests) == sorted(names)
    assert sorted(f for f in os.listdir(FIXTURES) if f.endswith(".jpg")) \
        == sorted(names)
    for name in names:
        for mode in ("RGB", "L"):
            assert _digest(pil_decode(os.path.join(FIXTURES, name), mode)) \
                == digests[name][mode], (name, mode)


def test_decoder_matches_the_committed_digests():
    """The check the GPU smoke makes on the card, here: the port's decode
    of every fixture has PIL's digest."""
    for name, modes in _digests().items():
        for mode, want in modes.items():
            assert _digest(decode_jpeg(os.path.join(FIXTURES, name), mode)) \
                == want, (name, mode)


@pytest.mark.parametrize("modality", ["RGB", "Flow", "RGBDiff"])
def test_directory_provider_matches_jax(tmp_path, modality):
    """The port's DirectoryFrameProvider (its decoder) and the JAX
    package's (PIL) load the same arrays from one frame directory, as the
    plain version (:func:`load_with_pil`) does."""
    link_frames(str(tmp_path), "video_0", 20, modality)
    tmpl = frame_template(modality)
    port = DirectoryFrameProvider(str(tmp_path), tmpl, modality)
    ref = JDirectoryFrameProvider(str(tmp_path), tmpl, modality)
    for idx in (1, 2, 9, 17, 20):
        got, want = port.load("video_0", idx), ref.load("video_0", idx)
        plain = load_with_pil(port, "video_0", idx)
        assert len(got) == len(want) == (2 if modality == "Flow" else 1)
        for g, w, p in zip(got, want, plain):
            w = np.asarray(w)
            assert g.dtype == np.uint8 and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, p)


def test_decoder_is_a_library_of_its_own(tmp_path):
    """``libadt_jpeg`` builds into the given directory, with its log, apart
    from ``libadt_native``; a second call reuses it."""
    path = jpeg.build_jpeg(str(tmp_path))
    assert os.path.basename(path).startswith("libadt_jpeg_")
    assert os.path.isfile(path) and os.path.isfile(path + ".log")
    assert not any(f.startswith("libadt_native") for f in
                   os.listdir(tmp_path))
    mtime = os.path.getmtime(path)
    assert jpeg.build_jpeg(str(tmp_path)) == path
    assert os.path.getmtime(path) == mtime


def test_broken_compiler_raises_importerror_naming_the_log(tmp_path,
                                                           monkeypatch):
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(ImportError,
                       match=r"JPEG decoder did not build \(log .*\.log\)"):
        jpeg.build_jpeg(str(tmp_path))
    assert not any(f.endswith(".so") for f in os.listdir(tmp_path))


def test_each_decode_counts_as_host_jpeg_decode():
    reset_launch_counts()
    path = os.path.join(FIXTURES, FLOW_FIXTURES[0])
    decode_jpeg(path, "L")
    decode_jpeg(path, "RGB")
    provider = DirectoryFrameProvider(FIXTURES, "{}_{:05d}.jpg", "Flow")
    provider.load("", 3)
    assert launch_counts()["host_jpeg_decode"] == 4
    reset_launch_counts()
    assert launch_counts()["host_jpeg_decode"] == 0


if __name__ == "__main__":
    write_fixtures()
