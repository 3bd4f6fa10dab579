"""A configuration's layer table: each conv, pool and head of the scoring
algorithm with its shapes and precision, from which the per-layer metrics
count operations and bytes (``peaks.py``). The table lives in the
configuration's file; :func:`scoring_table` derives it from the plain
reference by running it on shapes alone (PyTorch's ``meta`` device), and a
CPU test holds the files to it.

Rows are ``{"name", "op", "precision", "per", "in", "out"[, "kernel",
"stride"]}``: ``in`` and ``out`` are ``[H, W, C]`` of one image (``[D]``
and ``[C]`` for a head); ``per`` names how many times a sampled tick
applies the row, a key of the configuration's ``per_tick``. The 1x1 convs
that read one tensor (a module's branch entries) are one row, as one conv
computes them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch
import torch.nn.functional as F

from . import peaks


class _Recorder:
    """Records each conv and pool the reference runs, on meta tensors."""

    def __init__(self):
        self.rows: List[dict] = []
        self._name = None
        self._reads: Dict[int, int] = {}     # id(input) -> row of its 1x1s
        self._inputs: list = []              # keeps those ids unique

    def act(self, name, x):
        return x

    def weight(self, name, w):
        self._name = name
        return w

    @contextlib.contextmanager
    def patched(self):
        conv, mp, ap = F.conv2d, F.max_pool2d, F.avg_pool2d

        def conv2d(x, w, b=None, stride=1, padding=0, *a, **k):
            y = conv(x, w, b, stride, padding, *a, **k)
            kh, kw = w.shape[2:]
            row = self._reads.get(id(x)) if (kh, kw, stride) == (1, 1, 1) \
                else None
            if row is not None:       # another 1x1 on the same input
                r = self.rows[row]
                r["out"][2] += y.shape[1]
                r["name"] += "+" + self._name
            else:
                self.rows.append({"name": self._name, "op": "conv",
                                  "in": _hwc(x), "out": _hwc(y),
                                  "kernel": [kh, kw], "stride": stride})
                if (kh, kw, stride) == (1, 1, 1):
                    self._reads[id(x)] = len(self.rows) - 1
                    self._inputs.append(x)
            return y

        def pool(kind, fn):
            def run(x, kernel, stride=None, padding=0, *a, **k):
                y = fn(x, kernel, stride, padding, *a, **k)
                self.rows.append({"name": f"{kind} after {self._name}",
                                  "op": kind, "in": _hwc(x), "out": _hwc(y),
                                  "kernel": [kernel, kernel],
                                  "stride": stride})
                return y
            return run

        F.conv2d, F.max_pool2d = conv2d, pool("max_pool", mp)
        F.avg_pool2d = pool("avg_pool", ap)
        try:
            yield self
        finally:
            F.conv2d, F.max_pool2d, F.avg_pool2d = conv, mp, ap


def _hwc(t: torch.Tensor) -> list:
    return [int(t.shape[2]), int(t.shape[3]), int(t.shape[1])]


def _meta_params(shapes: Dict[str, tuple]) -> dict:
    return {k: torch.empty(s, device="meta") for k, s in shapes.items()}


def scoring_table(arch_module, shapes: Dict[str, tuple], frame_hw, crop: int,
                  stem_precision: str, trunk_precision: str,
                  feature_dim: int, head_cols: int) -> List[dict]:
    """The rows of shared-stem scoring: the stem over a scaled frame
    (``per`` "stem"), the trunk over one crop window (``per`` "crop") and
    the fused heads over one tick's mean feature (``per`` "tick", float32).
    ``shapes`` maps each backbone parameter to its shape."""
    p = _meta_params(shapes)
    rec = _Recorder()
    with rec.patched():
        x = torch.empty((1, 3) + tuple(frame_hw), device="meta")
        arch_module.stem(p, x, rec)
        n_stem = len(rec.rows)
        fc = arch_module.stem_hw(crop)
        arch_module.trunk(p, torch.empty((1, 192, fc, fc), device="meta"),
                          rec)
    rows = rec.rows
    for i, r in enumerate(rows):
        r["per"] = "stem" if i < n_stem else "crop"
        r["precision"] = stem_precision if i < n_stem else trunk_precision
    rows.append({"name": "heads", "op": "fc", "precision": "f32",
                 "per": "tick", "in": [feature_dim], "out": [head_cols]})
    return rows


def per_tick(cfg: dict, fn, keep=lambda row: True) -> float:
    """``sum(fn(row) * per_tick[row["per"]])`` over the configuration's
    scoring rows that ``keep`` keeps."""
    return sum(fn(r) * cfg["per_tick"][r["per"]]
               for r in cfg["score_layers"] if keep(r))


def peak_seconds_per_tick(cfg: dict) -> float:
    """Seconds a tick's convs and heads take at their precisions' peaks."""
    return per_tick(cfg, peaks.peak_seconds,
                    lambda r: r["op"] in ("conv", "fc"))
