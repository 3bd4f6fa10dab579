"""ctypes bindings to the port's C++ host kernels (``csrc/adt_native.cpp``):
greedy temporal NMS, the TAG box search, and the row gather that builds a
scoring chunk in its staging slot (``infer/features.py``).

The library builds at first call, not at import, with one
``g++ -O2 -std=c++17 -shared -fPIC`` (``$CXX`` picks another compiler) into
``action_detection_torch/_build/``, named by a hash of the source and the
command. A failed build raises ``ImportError`` with the compiler's log, which
is also kept beside the library as ``<library>.log``: nothing falls back to
numpy. The numpy bodies in ``ops/nms.py`` and ``ops/tag.py``
(``temporal_nms_indices_plain``, ``tag_box_search_plain``) and
:func:`gather_rows_plain` are the plain versions the tests hold these
against.

Each wrapper adds one to its ``launches`` where it calls into the library
(``kernels.launch_counts()`` lists them as ``host_nms``,
``host_tag_search`` and ``host_gather_rows``).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from .build import BUILD_DIR, CSRC, build_host_library

SOURCE = os.path.join(CSRC, "adt_native.cpp")

_D = ctypes.POINTER(ctypes.c_double)
_L = ctypes.POINTER(ctypes.c_int64)
_I64 = ctypes.c_int64
SIGNATURES = {
    # starts, ends, scores, n, thresh, duration_offset, out_indices
    "adt_temporal_nms": [_D, _D, _D, _I64, ctypes.c_double, ctypes.c_double,
                         _L],
    # labels, scores, length, up, down, n_up, tol, n_tol, out, capacity_rows
    "adt_tag_box_search": [_L, _D, _I64, _L, _L, _I64, _D, _I64, _D, _I64],
    # dst, row pointers, n, row_bytes
    "adt_gather_rows": [ctypes.c_void_p, ctypes.c_void_p, _I64, _I64],
}


def build_native(build_dir: str = BUILD_DIR) -> str:
    """Compile ``csrc/adt_native.cpp`` unless this source and command have a
    library in ``build_dir`` already; returns its path."""
    return build_host_library("libadt_native", [SOURCE],
                              "the C++ host kernels", build_dir)


@functools.lru_cache(maxsize=None)
def load_native() -> ctypes.CDLL:
    """The built host library with every entry point's signature set."""
    lib = ctypes.CDLL(build_native())
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int64
    return lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(_L)


def nms_indices(starts, ends, scores, thresh: float,
                duration_offset: float = 0.0) -> np.ndarray:
    """Greedy temporal NMS; kept indices in descending-score order."""
    starts = np.ascontiguousarray(starts, dtype=np.float64)
    ends = np.ascontiguousarray(ends, dtype=np.float64)
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    n = len(scores)
    if not len(starts) == len(ends) == n:
        raise ValueError(f"nms_indices: {len(starts)} starts, {len(ends)} "
                         f"ends, {n} scores")
    out = np.empty(n, dtype=np.int64)
    lib = load_native()
    nms_indices.launches += 1
    n_keep = lib.adt_temporal_nms(_dptr(starts), _dptr(ends), _dptr(scores),
                                  n, thresh, duration_offset, _iptr(out))
    return out[:n_keep].copy()


def tag_box_search(labels, scores, up, down, tol) -> np.ndarray:
    """TAG flood-fill box search; returns (rows, 3) [start, end, score]."""
    labels = np.ascontiguousarray(labels, dtype=np.int64)
    scores = np.ascontiguousarray(scores, dtype=np.float64)
    up = np.ascontiguousarray(up, dtype=np.int64)
    down = np.ascontiguousarray(down, dtype=np.int64)
    tol = np.ascontiguousarray(tol, dtype=np.float64)
    if len(scores) != len(labels) or len(down) != len(up):
        raise ValueError(f"tag_box_search: {len(labels)} labels, "
                         f"{len(scores)} scores, {len(up)} up, "
                         f"{len(down)} down transitions")
    capacity = 2 * len(up) * len(tol)
    out = np.empty((max(capacity, 1), 3), dtype=np.float64)
    lib = load_native()
    tag_box_search.launches += 1
    rows = lib.adt_tag_box_search(_iptr(labels), _dptr(scores), len(labels),
                                  _iptr(up), _iptr(down), len(up),
                                  _dptr(tol), len(tol), _dptr(out), capacity)
    return out[:rows].copy()


def gather_rows(out: np.ndarray, rows) -> None:
    """``out[i] = rows[i]`` for each row (a partial ``out`` keeps its other
    rows), in one call with the GIL released: a copy a row through numpy
    gives the GIL up and takes it back once a row, and the decode pool's
    threads take it in between. Each row has ``out``'s row shape and
    dtype (others raise ``ValueError``); ``out`` is C-contiguous."""
    if not (isinstance(out, np.ndarray) and out.flags.c_contiguous
            and out.flags.writeable):
        raise ValueError("gather_rows: out is not a writeable C-contiguous "
                         "array")
    if len(rows) > out.shape[0]:
        raise ValueError(f"gather_rows: {len(rows)} rows into "
                         f"{out.shape[0]}")
    rows = [np.ascontiguousarray(r) for r in rows]
    for r in rows:
        if r.shape != out.shape[1:] or r.dtype != out.dtype:
            raise ValueError(f"gather_rows: a row of {r.shape} {r.dtype} "
                             f"into rows of {out.shape[1:]} {out.dtype}")
    ptrs = (ctypes.c_void_p * len(rows))(*[r.ctypes.data for r in rows])
    lib = load_native()
    gather_rows.launches += 1
    lib.adt_gather_rows(out.ctypes.data, ptrs, len(rows),
                        out[0].nbytes if len(out) else 0)


def gather_rows_plain(out: np.ndarray, rows) -> None:
    """:func:`gather_rows`'s plain version: one numpy copy a row."""
    for i, r in enumerate(rows):
        out[i] = r


nms_indices.launches = 0
tag_box_search.launches = 0
gather_rows.launches = 0
