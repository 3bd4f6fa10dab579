"""Build and load the port's CUDA kernels.

The sources in ``action_detection_torch/csrc/*.cu`` compile with nvcc into
one shared library with a plain C interface, bound with ctypes. The build
runs at first use into ``action_detection_torch/_build/`` (listed in
.gitignore), named by a hash of the sources and flags so an edited source
rebuilds: one nvcc per source, all started together, then one link. The
assembler's report of each kernel's registers, shared memory and spills
(``-Xptxas -v``) is kept beside the library as ``<library>.log``. A missing
nvcc or a failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile
import time

from ..utils.build import BUILD_DIR, CSRC, hashed_library_path

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
SIGNATURES = {
    # x, w, scale, bias, out, N, H, W, C, x_pix_stride, O, KH, KW, stride,
    # pad_h, pad_w, Ho, Wo, bn, out_bf16, stream
    "adt_int8_conv": [_P] * 5 + [_I] * 15 + [_P],
    # x, out, N, H, W, C, Ho, Wo, stride, pad, tile_h, tile_w, slab, stream
    "adt_int8_max_pool": [_P] * 2 + [_I] * 11 + [_P],
    # x, out, N, H, W, C, tile_h, tile_w, slab, exclude_pad, stream
    "adt_int8_avg_pool": [_P] * 2 + [_I] * 8 + [_P],
    # x, y, dy, dx, plan (kernels/pool_bwd.py:PLAN_FIELDS), len(plan), stream
    "adt_max_pool_bwd": [_P] * 4 + [ctypes.POINTER(_I), _I, _P],
}


def _sources():
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.isfile(cand):
        return cand
    raise RuntimeError("nvcc not found (neither on PATH nor under "
                       f"{cuda_home}/bin): the CUDA kernels cannot be built")


def build_library() -> tuple:
    """Compile the kernels if this source hash has no library yet.

    Returns ``(path, seconds spent compiling)``; 0.0 when it was built.
    """
    srcs = _sources()
    path = hashed_library_path("libadt_kernels", NVCC_FLAGS, srcs)
    if os.path.isfile(path):
        return path, 0.0
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in (s for s in srcs if s.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = [(src, p.communicate()[0], p.returncode) for src, p in procs]
        failed = [f"{os.path.basename(src)} (rc {rc}):\n{out}"
                  for src, out, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        lib = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                               *objs], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc {proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        with open(path + ".log", "w") as f:
            f.writelines(f"== {os.path.basename(src)}\n{out}"
                         for src, out, _ in logs)
        os.replace(lib, path)
    return path, time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built kernel library with every entry point's signature set."""
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
