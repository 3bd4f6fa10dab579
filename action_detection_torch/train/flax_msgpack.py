"""A reader and a writer of the msgpack that flax writes, in pure Python.

``flax.serialization.msgpack_serialize`` is how the JAX package writes its
``checkpoint.msgpack`` files (``action_detection_tpu/train/checkpoint.py``).
The machines the port runs on have neither flax nor the ``msgpack``
package, so this module reads and writes that format itself:

* msgpack's maps, arrays, str, bin, int, float, bool and nil (lengths and
  numbers big-endian);
* ext type 1, an ndarray: its payload is itself msgpack, the array
  ``(shape, dtype name, C-order bytes)``;
* ext type 3, a numpy scalar (``epoch``, ``best_loss``): an ndarray
  payload of shape ``()``;
* ``bfloat16`` leaves (numpy has no such dtype): read as uint16 and viewed
  as ``torch.bfloat16`` tensors; the writer takes such tensors back;
* chunked arrays: flax splits a leaf of more than ``MAX_CHUNK_SIZE`` bytes
  into a map ``{"__msgpack_chunked_array__": True, "shape": {"0": ...},
  "chunks": {"0": ..., ...}}`` of flat pieces, rejoined here.

Array leaves are read with ``np.frombuffer`` on a view of the file's bytes,
not copied (VGG-16's fc6 is 411 MB); they are read-only. The writer packs
as flax's ``msgpack_serialize`` does (dict keys sorted, the smallest
encoding of each length and integer, float64 for floats, ``use_bin_type``),
so the two give the same bytes for the same tree.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

NDARRAY_EXT = 1
NPSCALAR_EXT = 3
#: flax's chunking threshold, bytes of one array leaf
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """msgpack decoding over a memoryview. ``raw`` keeps str as bytes (the
    ndarray payload's dtype name, as flax reads it); ``views`` returns bin
    as a memoryview of the data, not a copy (the payload's array bytes)."""

    def __init__(self, data, raw: bool = False, views: bool = False):
        self.mv = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.views = views

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.mv):
            raise ValueError(f"msgpack data ends at byte {len(self.mv)}, "
                             f"{self.pos + n} needed")
        out = self.mv[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext_unpack(code, self.take(n))

    def read(self) -> Any:
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if t in sized:
            b = self.take(self.unpack(sized[t]))
            return b if self.views else bytes(b)
        if t in (0xC7, 0xC8, 0xC9):
            return self.ext(self.unpack({0xC7: ">B", 0xC8: ">H",
                                         0xC9: ">I"}[t]))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if t in numbers:
            return self.unpack(numbers[t])
        if 0xD4 <= t <= 0xD8:
            return self.ext(1 << (t - 0xD4))
        if t in (0xD9, 0xDA, 0xDB):
            return self.str_(self.unpack({0xD9: ">B", 0xDA: ">H",
                                          0xDB: ">I"}[t]))
        if t in (0xDC, 0xDD):
            return [self.read() for _ in range(
                self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):
            return self.map_(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{t:02x} at byte "
                         f"{self.pos - 1}")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out


def _ndarray_from_payload(payload: memoryview):
    shape, name, buf = _Reader(payload, raw=True, views=True).read()
    if not isinstance(buf, memoryview):
        raise ValueError("msgpack ndarray: no byte buffer")
    if name == b"bfloat16":
        a = np.frombuffer(buf, dtype=np.uint16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(shape)


def _ext_unpack(code: int, payload: memoryview):
    if code == NDARRAY_EXT:
        return _ndarray_from_payload(payload)
    if code == NPSCALAR_EXT:
        a = _ndarray_from_payload(payload)
        return a.reshape(()) if isinstance(a, torch.Tensor) else a[()]
    raise ValueError(f"msgpack ext type {code} is not a flax array")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(node):
    if isinstance(node, dict):
        if CHUNKED in node:
            return _unchunk(node)
        return {k: _unchunk_tree(v) for k, v in node.items()}
    return node


def restore(data) -> Any:
    """msgpack bytes (as flax's ``msgpack_restore`` reads them) -> the tree:
    dicts, lists, str, bytes, numbers, numpy arrays and scalars, bfloat16
    tensors, chunked leaves rejoined."""
    r = _Reader(data)
    tree = r.read()
    if r.pos != len(r.mv):
        raise ValueError(f"msgpack: {len(r.mv) - r.pos} bytes after the "
                         "object")
    return _unchunk_tree(tree)


def read(path: str) -> Any:
    """:func:`restore` of the file at ``path``."""
    with open(path, "rb") as f:
        return restore(f.read())


# -- writing ---------------------------------------------------------------

def _pack_len(out: list, n: int, fix: Tuple[int, int], codes: Tuple[int, ...]
              ) -> None:
    """A length header: the fix form below ``fix[1]`` items, else 8-, 16-
    or 32-bit (``codes`` lists the byte for each that the type has)."""
    base, limit = fix
    if base is not None and n < limit:
        out.append(bytes([base | n]))
        return
    forms = dict(zip((">B", ">H", ">I")[3 - len(codes):], codes))
    for fmt, code in forms.items():
        if n < 1 << (8 * struct.calcsize(fmt)):
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack: length {n} too large")


def _pack_int(out: list, v: int) -> None:
    if 0 <= v < 0x80 or -32 <= v < 0:
        out.append(struct.pack(">b" if v < 0 else ">B", v))
        return
    forms = (((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q"))
             if v >= 0 else
             ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q")))
    for code, fmt in forms:
        bits = 8 * struct.calcsize(fmt)
        if (v < 1 << bits) if v >= 0 else (v >= -(1 << (bits - 1))):
            out.append(bytes([code]) + struct.pack(fmt, v))
            return
    raise ValueError(f"msgpack: integer {v} out of range")


def _pack_ext(out: list, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes([fixed[n], code]))
    else:
        _pack_len(out, n, (None, 0), (0xC7, 0xC8, 0xC9))
        out.append(struct.pack(">b", code))
    out.append(payload)


def _ndarray_payload(a) -> bytes:
    """``(shape, dtype name, C bytes)`` packed, as flax's
    ``_ndarray_to_bytes``."""
    if isinstance(a, torch.Tensor):
        if a.dtype != torch.bfloat16:
            raise TypeError(f"msgpack: tensors other than bfloat16 are "
                            f"written as numpy arrays, got {a.dtype}")
        shape, name = tuple(a.shape), "bfloat16"
        buf = a.detach().cpu().contiguous().view(torch.uint16).numpy()
    else:
        if a.dtype.hasobject or a.dtype.isalignedstruct:
            raise ValueError("msgpack: object and structured dtypes are not "
                             "written")
        shape, name, buf = a.shape, a.dtype.name, a
    out: list = []
    _pack(out, [list(shape), name, np.ascontiguousarray(buf).tobytes()])
    return b"".join(out)


def _pack(out: list, v) -> None:
    # numpy scalars before Python's types: np.float64 is a float
    if isinstance(v, (np.ndarray, torch.Tensor)):
        _pack_ext(out, NDARRAY_EXT, _ndarray_payload(v))
    elif isinstance(v, np.generic):
        _pack_ext(out, NPSCALAR_EXT, _ndarray_payload(np.asarray(v)))
    elif v is None:
        out.append(b"\xc0")
    elif v is True or v is False:
        out.append(b"\xc3" if v else b"\xc2")
    elif type(v) is int:
        _pack_int(out, v)
    elif type(v) is float:
        out.append(b"\xcb" + struct.pack(">d", v))
    elif type(v) is str:
        b = v.encode("utf-8")
        _pack_len(out, len(b), (0xA0, 32), (0xD9, 0xDA, 0xDB))
        out.append(b)
    elif type(v) is bytes:
        _pack_len(out, len(v), (None, 0), (0xC4, 0xC5, 0xC6))
        out.append(v)
    elif type(v) is list:
        _pack_len(out, len(v), (0x90, 16), (0xDC, 0xDD))
        for x in v:
            _pack(out, x)
    elif type(v) is dict:
        _pack_len(out, len(v), (0x80, 16), (0xDE, 0xDF))
        for k, x in v.items():
            _pack(out, k)
            _pack(out, x)
    else:
        raise TypeError(f"msgpack: cannot write {type(v).__name__}")


def _chunk_tree(node):
    """The tree as flax packs it: every dict's keys sorted (flax copies the
    tree with ``jax.tree_util`` first, which sorts them), then leaves over
    ``MAX_CHUNK_SIZE`` bytes in flax's chunked form (whose keys keep their
    order)."""
    if isinstance(node, dict):
        return {k: _chunk_tree(node[k]) for k in sorted(node)}
    if isinstance(node, torch.Tensor):
        n, itemsize = node.numel(), node.element_size()
    elif isinstance(node, np.ndarray):
        n, itemsize = node.size, node.dtype.itemsize
    else:
        return node
    if n * itemsize <= MAX_CHUNK_SIZE:
        return node
    size = max(1, MAX_CHUNK_SIZE // itemsize)
    flat = node.reshape(-1)
    return {CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(node.shape)},
            "chunks": {str(i): flat[j:j + size] for i, j in enumerate(
                range(0, flat.shape[0], size))}}


def serialize(tree) -> bytes:
    """The tree (dicts with str keys, lists, str, bytes, numbers, None,
    numpy arrays and scalars, bfloat16 tensors) as flax's
    ``msgpack_serialize`` writes it."""
    out: list = []
    _pack(out, _chunk_tree(tree))
    return b"".join(out)
