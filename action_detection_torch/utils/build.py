"""Where the port's native libraries are built, and how they are named.

Both the CUDA kernels (``kernels/build.py``, nvcc) and the C++ host kernels
(``utils/native.py``, g++) compile at first use from ``csrc/`` into
``action_detection_torch/_build/`` (listed in .gitignore). A library's file
name carries a hash of its sources and its compiler command, so an edited
source or flag builds a new library beside the old one. This module imports
neither torch nor a compiler: the host-only CLIs reach it.
"""

from __future__ import annotations

import hashlib
import os
from typing import Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")


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
