"""Checkpoints (.pt) carrying regression-target statistics.

A checkpoint is a ``torch.save`` of ``{"state_dict", "reg_stats", "arch",
"epoch"}``. ``reg_stats`` MUST ride along: inference denormalizes the
regression outputs with it. Everything stored is a tensor, a string or an
int, so loading uses ``weights_only=True`` (no arbitrary unpickling).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping

import numpy as np
import torch


def save_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                    reg_stats, arch: str = "", epoch: int = 0) -> None:
    """Write a checkpoint atomically (temp file + rename)."""
    state = {"state_dict": {k: v.detach().cpu() for k, v in
                            state_dict.items()},
             "reg_stats": (torch.as_tensor(np.asarray(reg_stats))
                           if reg_stats is not None else None),
             "arch": arch, "epoch": int(epoch)}
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load a checkpoint: ``state_dict`` as CPU tensors, ``reg_stats`` as a
    numpy array (or None)."""
    ck = torch.load(path, map_location="cpu", weights_only=True)
    rs = ck.get("reg_stats")
    ck["reg_stats"] = rs.numpy() if rs is not None else None
    return ck
