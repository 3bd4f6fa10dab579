"""Checkpoints (.pt) carrying regression-target statistics.

A checkpoint is a ``torch.save`` of ``{"state_dict", "reg_stats", "arch",
"epoch", "best_loss"}``. ``reg_stats`` MUST ride along: inference
denormalizes the regression outputs with it. Everything stored is a tensor,
a string, an int or a float, so loading uses ``weights_only=True`` (no
arbitrary unpickling). Names and the ``model_best`` copy follow the JAX
package's ``train/checkpoint.py`` with ``.pt`` for ``.msgpack``.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Mapping

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


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint: ``state_dict`` as CPU tensors, ``reg_stats`` as a
    numpy array (or None), ``best_loss`` (inf where the file has none)."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    rs = ck.get("reg_stats")
    ck["reg_stats"] = rs.numpy() if rs is not None else None
    ck["best_loss"] = float(ck.get("best_loss", float("inf")))
    return ck
