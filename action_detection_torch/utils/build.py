"""Where the port's native libraries are built, and how they are named.

The CUDA kernels (``kernels/build.py``, nvcc), the C++ host kernels
(``utils/native.py``, g++) and the frame decoder (``data/image.py``, g++,
a library of its own) compile at first use from ``csrc/`` into
``action_detection_torch/_build/`` (listed in .gitignore). A library's file
name carries a hash of its sources and its compiler command, so an edited
source or flag builds a new library beside the old one. A build holds an
exclusive file lock beside its library (:func:`build_lock`), so processes
that start together (the ranks of a data-parallel run) build once and the
others load what it built. This module imports neither torch nor a
compiler: the host-only CLIs reach it.
"""

from __future__ import annotations

import contextlib
import fcntl
import hashlib
import os
import subprocess
import tempfile
from typing import Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
#: g++'s flags for a host library (``$CXX`` picks another compiler)
HOST_CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")


def hashed_library_path(stem: str, command: Iterable[str],
                        sources: Iterable[str],
                        build_dir: str = BUILD_DIR) -> str:
    """``<build_dir>/<stem>_<hash>.so``, the hash over ``command`` and the
    bytes of every source."""
    h = hashlib.sha256(" ".join(command).encode())
    for s in sources:
        with open(s, "rb") as f:
            h.update(f.read())
    return os.path.join(build_dir, f"{stem}_{h.hexdigest()[:16]}.so")


@contextlib.contextmanager
def build_lock(path: str):
    """Hold an exclusive ``flock`` on ``<path>.lock`` (its directory is
    made): whoever builds checks for ``path`` again once it holds the
    lock."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path + ".lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build_host_library(stem: str, sources: list, what: str,
                       build_dir: str = BUILD_DIR) -> str:
    """Compile the C++ files ``sources`` into one
    ``<build_dir>/<stem>_<hash>.so`` with ``$CXX`` (g++) and
    :data:`HOST_CXX_FLAGS`, unless that library is there already; returns
    its path. The compiler's output is kept as
    ``<library>.log``; a failed build raises ``ImportError`` naming ``what``
    and the log, with its text."""
    cxx = os.environ.get("CXX", "g++")
    path = hashed_library_path(stem, (cxx,) + HOST_CXX_FLAGS, sources,
                               build_dir)
    if os.path.isfile(path):
        return path
    with build_lock(path):
        if not os.path.isfile(path):    # nobody built it meanwhile
            _compile_host(cxx, sources, path, what, build_dir)
    return path


def _compile_host(cxx: str, sources: list, path: str, what: str,
                  build_dir: str) -> None:
    log = path + ".log"
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        lib = os.path.join(tmp, "lib.so")
        try:
            proc = subprocess.run([cxx, *HOST_CXX_FLAGS, "-o", lib, *sources],
                                  capture_output=True, text=True,
                                  timeout=300)
            out, ok = proc.stdout + proc.stderr, proc.returncode == 0
            out = f"{cxx} exited with {proc.returncode}\n{out}"
        except (OSError, subprocess.SubprocessError) as e:
            out, ok = f"{cxx} did not run: {e!r}\n", False
        with open(log, "w") as f:
            f.write(out)
        if not ok:
            raise ImportError(f"{what} did not build (log {log}):\n{out}")
        os.replace(lib, path)
