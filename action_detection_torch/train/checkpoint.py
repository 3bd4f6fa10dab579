"""Checkpoints carrying regression-target statistics.

The port writes a ``torch.save`` of ``{"state_dict", "reg_stats", "arch",
"epoch", "best_loss"}`` (``.pt``). ``reg_stats`` MUST ride along: inference
denormalizes the regression outputs with it. Names and the ``model_best``
copy follow the JAX package's ``train/checkpoint.py`` with ``.pt`` for
``.msgpack``.

:func:`load_checkpoint` reads three formats into that dict:

* the port's ``.pt``;
* the JAX package's ``checkpoint.msgpack`` (flax msgpack, read by
  :mod:`.flax_msgpack`; its flax trees mapped by
  ``models/convert.py:state_dict_from_jax``);
* a reference SSN or binary ``.pth``/``.pth.tar`` (``module.``-prefixed,
  ``reg_stats`` possibly a numpy array; ``models/convert.py:
  ssn_state_from_reference``), in torch's zip format or its older one.

Torch files load with ``weights_only=True``: nothing but tensors,
containers and numbers is unpickled, plus, by name, the numpy globals that
rebuild an array or a scalar (:data:`NUMPY_GLOBALS`, and the numeric
dtypes' classes, :data:`NUMPY_DTYPES`).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def checkpoint_name(snapshot_pref: str, dataset: str, arch: str,
                    modality: str, filename: str = "checkpoint.pt") -> str:
    """``ssn<pref>_<dataset>_<arch>_<modality>_checkpoint.pt``
    (``binary_checkpoint.pt`` for ``binary_train``)."""
    return "ssn" + "_".join((snapshot_pref, dataset, arch, modality.lower(),
                             filename))


def best_name(path: str) -> str:
    """The ``model_best`` copy of ``path``: ``checkpoint`` in the file name
    becomes ``model_best``, any other name gains a ``_model_best`` suffix."""
    head, tail = os.path.split(path)
    if "checkpoint" in tail:
        return os.path.join(head, tail.replace("checkpoint", "model_best"))
    root, ext = os.path.splitext(tail)
    return os.path.join(head, root + "_model_best" + ext)


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    reg_stats, arch: str = "", epoch: int = 0,
                    best_loss: float = float("inf"),
                    is_best: bool = False) -> None:
    """Write a checkpoint atomically (temp file + rename); with ``is_best``
    also its ``model_best`` copy (:func:`best_name`)."""
    state = {"state_dict": {k: v.detach().cpu() for k, v in
                            state_dict.items()},
             "reg_stats": (torch.as_tensor(np.asarray(reg_stats))
                           if reg_stats is not None else None),
             "arch": arch, "epoch": int(epoch),
             "best_loss": float(best_loss)}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    if is_best:
        shutil.copyfile(path, best_name(path))


#: the numpy globals a torch pickle of a numpy array or scalar names (numpy
#: 2's module path and numpy 1's), allowed by name and nothing else; with
#: them, the classes of the numeric dtypes (numpy >= 1.25 rebuilds a dtype
#: as an instance of its own class)
NUMPY_GLOBALS = ("numpy._core.multiarray._reconstruct",
                 "numpy.core.multiarray._reconstruct",
                 "numpy._core.multiarray.scalar",
                 "numpy.core.multiarray.scalar", "numpy.ndarray",
                 "numpy.dtype")
NUMPY_DTYPES = ("bool", "int8", "uint8", "int16", "uint16", "int32",
                "uint32", "int64", "uint64", "float16", "float32", "float64")


def _numpy_safe_globals() -> list:
    try:
        from numpy._core import multiarray
    except ImportError:     # numpy 1
        from numpy.core import multiarray

    objs = {"_reconstruct": multiarray._reconstruct,
            "scalar": multiarray.scalar, "ndarray": np.ndarray,
            "dtype": np.dtype}
    named = [(objs[name.rsplit(".", 1)[1]], name) for name in NUMPY_GLOBALS]
    classes = {type(np.dtype(t)) for t in NUMPY_DTYPES} - {np.dtype}
    return named + sorted(classes, key=lambda c: c.__name__)


def read_file(path: str) -> Tuple[str, Any]:
    """``(format, content)`` of a checkpoint file, the format read from its
    first bytes: ``("torch", ...)`` for torch's zip or older pickle format
    (``torch.load`` on the CPU, ``weights_only=True``, the numpy globals of
    :data:`NUMPY_GLOBALS` allowed) or ``("msgpack", tree)`` for a map, flax's
    top level (:mod:`.flax_msgpack`). Anything else, an orbax checkpoint
    directory included, raises ``ValueError`` naming it."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory: the port does not read the JAX "
            "package's orbax checkpoint directories (ROADMAP.md queue 1, "
            "'Data parallel'); pass a checkpoint.msgpack, a .pt or a .pth")
    with open(path, "rb") as f:
        head = f.read(2)
    if head[:2] == b"PK" or (len(head) == 2 and head[0] == 0x80
                             and 2 <= head[1] <= 5):
        with torch.serialization.safe_globals(_numpy_safe_globals()):
            return "torch", torch.load(path, map_location="cpu",
                                       weights_only=True)
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        from .flax_msgpack import read

        return "msgpack", read(path)
    raise ValueError(
        f"{path} is not a checkpoint the port reads (a port .pt, a JAX "
        "checkpoint.msgpack or a reference or torchvision .pth/.pth.tar)")


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a port ``.pt``, a JAX ``checkpoint.msgpack`` or a reference
    ``.pth``/``.pth.tar`` (:func:`read_file`): ``{"state_dict"`` (CPU
    tensors keyed as the port's models), ``"reg_stats"`` (a numpy array, or
    None), ``"arch"``, ``"epoch"``, ``"best_loss"`` (inf where the file has
    none)``}``."""
    from ..models.convert import ssn_state_from_reference, state_dict_from_jax

    kind, raw = read_file(path)
    if kind == "torch":
        return ssn_state_from_reference(raw)
    rs = raw.get("reg_stats")
    return {"state_dict": state_dict_from_jax(raw["params"],
                                              raw.get("batch_stats") or {}),
            "reg_stats": None if rs is None else np.array(rs),
            "arch": raw.get("arch", ""),
            "epoch": int(raw.get("epoch", 0)),
            "best_loss": float(raw.get("best_loss", float("inf")))}
