"""Plain BN-Inception at the precisions the scoring configuration states:
the stem in bf16 on BatchNorm-folded weights, the trunk int8 end to end
(int8 activations between layers, int8 weights per output channel, each
conv's output requantized to a scale of its own), calibrated on the
calibration crops as SSN's int8 scoring calibrates. Everything is worked
out here from the float weights (Caffe blob names, ``bn_inception.py``)
and the crops; integer convolutions run in float64, where every sum is
exact.

Calibration:

1. BatchNorm folds into each conv, in float32: ``w' = w g / sqrt(v +
   eps)``, ``b' = (b - m) g / sqrt(v + eps) + beta``.
2. A calibration pass over the crops records each conv's largest output.
   The stem runs in bf16 (:func:`_stem_bf16`); the trunk as a per-layer
   proxy: bf16 activations, each conv's input quantized per tensor at
   ``max|x| / 127``, its weights per output channel at ``max|w'| / 127``,
   its output ``bf16(max(y (sx sw) + b', 0))``; exact max pools; average
   pools summed in bf16 window cell by window cell, then divided by 9.
3. A conv's output scale is its largest output over ``levels`` (float64).
   A trunk conv's weights absorb the per-channel scales of its input and
   quantize per output channel at ``max|w| / levels``; its epilogue takes
   the exact integer sum ``y`` to ``clip(round(max(y m + bq, 0)), 0,
   levels)`` with ``m = sw / so`` and ``bq = b' / so`` in float32, each
   product and sum rounded on its own, ties to even.

The forward: the bf16 stem (each conv, bias add and ReLU rounded to bf16),
quantized once at ``conv2_3x3``'s scale; the int8 trunk with exact max
pools and 3x3 average pools that count the padding and round half to
even; the features are the last concat's spatial mean times its
per-channel scales.

``levels`` 127 is the configuration's int8; the control takes 7 (int4)
in the trunk and an int8 stem: the input quantized per tensor at its
largest magnitude over 127 and the stem's convs integer as the trunk's.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from .bn_inception import BN_EPS, MODULES, stem_hw

STEM_CONVS = ("conv1_7x7_s2", "conv2_3x3_reduce", "conv2_3x3")


def fold(p: dict) -> Dict[str, tuple]:
    """``{conv: (w' OIHW, b')}``, NumPy float32 on the host, for every conv
    with a BatchNorm."""
    def host(t):
        return t.detach().float().cpu().numpy()

    out = {}
    for key in p:
        name = key[:-len(".weight")]
        if not key.endswith(".weight") or \
                name + "_bn.running_var" not in p:
            continue
        bn = name + "_bn"
        inv = host(p[bn + ".weight"]) / np.sqrt(
            host(p[bn + ".running_var"]) + np.float32(BN_EPS))
        w = host(p[key]) * inv[:, None, None, None]
        b = (host(p[name + ".bias"]) - host(p[bn + ".running_mean"])) \
            * inv + host(p[bn + ".bias"])
        out[name] = (w, b)
    return out


def _int_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int,
              pad: int) -> torch.Tensor:
    """The exact integer sums of an int-valued conv, as float32 (through
    int32, as an int8 kernel's accumulator). Rounded to the integer first:
    a library may sum a float64 conv by a transform (Winograd, FFT) that
    is off by far less than one."""
    y = F.conv2d(xq.double(), wq.double(), stride=stride, padding=pad)
    return torch.round(y).to(torch.int32).to(torch.float32)


def _per_channel(w: np.ndarray, levels: int):
    """Per-output-channel scales ``max|w| / levels`` (1 where a channel
    is all zero) and the weights rounded to them, in ``w``'s float type."""
    sw = np.max(np.abs(w), axis=(1, 2, 3)) / w.dtype.type(levels)
    sw = np.where(sw == 0, w.dtype.type(1), sw)
    wq = np.clip(np.round(w / sw[:, None, None, None]), -levels, levels)
    return sw, wq


def _avg_pool_bf16(x: torch.Tensor) -> torch.Tensor:
    """3x3 s1 p1 average pool of a bf16 NCHW tensor, padding counted: the
    window summed in bf16 cell by cell in row-major order, then divided
    by 9 in bf16."""
    N, C, H, W = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    acc = torch.zeros_like(x)
    for ky in range(3):
        for kx in range(3):
            acc = acc + xp[:, :, ky:ky + H, kx:kx + W]
    return acc / 9.0


def _stem_bf16(folded: dict, x: torch.Tensor, maxes: dict = None):
    """Normalized NCHW float frames -> the bf16 stem output (NCHW)."""
    h = x.to(torch.bfloat16)
    if h.is_cuda:
        h = h.contiguous(memory_format=torch.channels_last)
    for name, stride, pad, pool in (("conv1_7x7_s2", 2, 3, True),
                                    ("conv2_3x3_reduce", 1, 0, False),
                                    ("conv2_3x3", 1, 1, True)):
        w, b = (torch.from_numpy(t).to(h.device, torch.bfloat16)
                for t in folded[name])
        y = F.conv2d(h, w, stride=stride, padding=pad)
        h = torch.clamp_min(y + b.view(1, -1, 1, 1), 0)
        if maxes is not None:
            maxes[name] = float(h.amax().float())
        if pool:
            h = F.max_pool2d(h, 3, 2, ceil_mode=True)
    return h


def _walk(conv, x, avg_pool=None, max_pool=None, cat=None):
    """BN-Inception's trunk over ``conv(name, x, stride, pad)``; the pools
    and the concat default to exact max pools, no average pool and a
    concat along channels (the scale walk passes its own)."""
    max_pool = max_pool or (lambda x, stride: F.max_pool2d(
        x, 3, stride, 1 if stride == 1 else 0, ceil_mode=stride == 2))
    cat = cat or (lambda parts: torch.cat(parts, dim=1))
    for name, c1, _c3r, _c3, _d3r, _d31, _d32, _proj, pool, stride in MODULES:
        out = []
        if c1 is not None:
            out.append(conv(f"{name}_1x1", x, 1, 0))
        b = conv(f"{name}_3x3_reduce", x, 1, 0)
        out.append(conv(f"{name}_3x3", b, stride, 1))
        b = conv(f"{name}_double_3x3_reduce", x, 1, 0)
        b = conv(f"{name}_double_3x3_1", b, 1, 1)
        out.append(conv(f"{name}_double_3x3_2", b, stride, 1))
        if stride == 1:
            b = avg_pool(x) if pool == "avg" else max_pool(x, 1)
            out.append(conv(f"{name}_pool_proj", b, 1, 0))
        else:
            out.append(max_pool(x, 2))
        x = cat(out)
    return x


def calibration_maxes(folded: dict, crops: torch.Tensor,
                      stem_bf16: bool = True) -> Dict[str, float]:
    """Step 2: ``{"input": max|crops|, conv: largest output}`` over the
    normalized NCHW calibration ``crops``. Without ``stem_bf16`` the stem
    runs the trunk's proxy as well."""
    maxes = {"input": float(crops.abs().amax())}
    per_layer = {}
    for name, (w, b) in folded.items():
        sw, wq = _per_channel(w, 127)
        per_layer[name] = tuple(torch.from_numpy(t).to(crops.device)
                                for t in (sw, wq, b))

    def conv(name, x, stride, pad):
        sx = torch.clamp_min(x.abs().amax().float() / 127.0, 1e-8)
        xq = torch.clamp(torch.round(x.float() / sx), -127, 127)
        sw, wq, b = per_layer[name]
        y = _int_conv(xq, wq, stride, pad)
        out = torch.clamp_min(y * (sx * sw).view(1, -1, 1, 1)
                              + b.view(1, -1, 1, 1), 0)
        out = out.to(torch.bfloat16)
        maxes[name] = float(out.amax().float())
        return out

    with torch.no_grad():
        if stem_bf16:
            h = _stem_bf16(folded, crops, maxes)
        else:
            h = conv("conv1_7x7_s2", crops.to(torch.bfloat16), 2, 3)
            h = F.max_pool2d(h, 3, 2, ceil_mode=True)
            h = conv("conv2_3x3_reduce", h, 1, 0)
            h = F.max_pool2d(conv("conv2_3x3", h, 1, 1), 3, 2,
                             ceil_mode=True)
        _walk(conv, h, _avg_pool_bf16)
    return maxes


class Int8BNInception:
    """The calibrated network: :meth:`stem` (normalized NCHW frames -> the
    trunk's int-valued input) and :meth:`trunk` (crop windows -> features),
    split where shared-stem scoring splits it."""

    stem_hw = staticmethod(stem_hw)

    def __init__(self, p: dict, crops: torch.Tensor, levels: int = 127,
                 stem: str = "bf16"):
        if stem not in ("bf16", "int8"):
            raise ValueError(f"stem {stem!r}: bf16 or int8")
        self.stem_mode = stem
        self.folded = fold(p)
        #: each conv's levels: the trunk's ``levels``, an int8 stem's 127
        self.levels = {name: 127 if name in STEM_CONVS else levels
                       for name in self.folded}
        maxes = calibration_maxes(self.folded, crops, stem == "bf16")
        self.scale = {k: max(v, 1e-8) / self.levels.get(k, 127)
                      for k, v in maxes.items()}
        self.layers: Dict[str, tuple] = {}
        if stem == "bf16":
            self.stem_scale = torch.tensor(self.scale["conv2_3x3"],
                                           dtype=torch.float32)
            sx = np.full(192, self.scale["conv2_3x3"])
        else:
            self.input_scale = torch.tensor(self.scale["input"],
                                            dtype=torch.float32)
            sx = np.full(3, self.scale["input"])
            for name in STEM_CONVS:
                sx = self._layer(name, sx, crops.device)
        self.feat_scale = torch.from_numpy(_walk(
            lambda name, s, stride, pad: self._layer(name, s, crops.device),
            sx, avg_pool=lambda s: s, max_pool=lambda s, stride: s,
            cat=np.concatenate).astype(np.float32))

    def _layer(self, name: str, sx: np.ndarray, device) -> np.ndarray:
        """Step 3 for one conv, in float64 on the host: its integer weights
        and epilogue from its input's per-channel scales ``sx``; returns
        its output's scales."""
        levels = self.levels[name]
        w, b = self.folded[name]
        sw, wq = _per_channel(w.astype(np.float64) * sx[None, :, None, None],
                              levels)
        so = self.scale[name]
        self.layers[name] = tuple(
            torch.from_numpy(t).to(device) for t in (
                wq, (sw / so).astype(np.float32),
                (b.astype(np.float64) / so).astype(np.float32)))
        return np.full(w.shape[0], so)

    def _conv(self, name: str, xq: torch.Tensor, stride: int, pad: int):
        wq, m, bq = self.layers[name]
        y = _int_conv(xq, wq, stride, pad)
        out = torch.clamp_min(y * m.view(1, -1, 1, 1)
                              + bq.view(1, -1, 1, 1), 0)
        return torch.clamp(torch.round(out), 0, self.levels[name])

    @staticmethod
    def _avg_pool(xq: torch.Tensor) -> torch.Tensor:
        s = F.avg_pool2d(xq.double(), 3, 1, 1, divisor_override=1)
        return torch.round(s.float() / 9.0)

    def stem(self, x: torch.Tensor) -> torch.Tensor:
        """Normalized NCHW frames -> the trunk's input (NCHW, 192 channels
        of int values)."""
        with torch.no_grad():
            if self.stem_mode == "bf16":
                h = _stem_bf16(self.folded, x)
                return torch.clamp(torch.round(
                    h.float() / self.stem_scale.to(h.device)), 0, 127)
            h = torch.clamp(torch.round(
                x.float() / self.input_scale.to(x.device)), -127, 127)
            h = F.max_pool2d(self._conv("conv1_7x7_s2", h, 2, 3), 3, 2,
                             ceil_mode=True)
            h = self._conv("conv2_3x3_reduce", h, 1, 0)
            return F.max_pool2d(self._conv("conv2_3x3", h, 1, 1), 3, 2,
                                ceil_mode=True)

    def trunk(self, xq: torch.Tensor) -> torch.Tensor:
        """Int-valued NCHW trunk input -> (N, 1024) features."""
        with torch.no_grad():
            h = _walk(self._conv, xq, self._avg_pool)
            return h.mean(dim=(2, 3)) * self.feat_scale.to(h.device)

#: the network that a configuration's ``stated`` entry takes from here
Network = Int8BNInception
