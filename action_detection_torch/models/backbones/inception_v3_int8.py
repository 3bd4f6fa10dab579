"""Int8 end-to-end InceptionV3 for scoring (torch port).

Port of ``action_detection_tpu/models/backbones/inception_v3_int8.py``, the
JAX CLI's default for ``--arch InceptionV3``. Same scale design as the
BNInception path (``bn_inception_int8.py``): every trunk conv requantizes its
own post-ReLU output to a calibrated per-conv scale in its epilogue, and each
consumer absorbs its input's per-channel scales into its weights, so branch
concats (Mixed_7b/7c's nested ones included) and pools need no
requantization.

The topology is written once (:func:`_walk_stem`, :func:`_walk_trunk`, the
JAX package's, which also hands each branch's last op its slot of the
module's output: ``module_slots`` and ``out=``, as in
``bn_inception_int8``) and interpreted by several ops faces:

* ``_CalibOps`` — the float forward in bf16 on the BN-folded weights
  (cuDNN on the card), recording each conv's post-ReLU output max;
* ``_ScaleOps`` — the host numpy scale algebra (copied): a "tensor" is a
  per-channel activation-scale vector;
* ``_ForwardOps`` — the int8 runtime on the hand-written kernels: K1 with
  per-axis padding (1x7/7x1/1x3/3x1/5x5) and the fused branch-entry conv, K2
  without padding (the VALID 3x3 s2 pools), K3 in its exclude-pad mode (the
  3x3 s1 SAME pools divide by 9, 6 or 4 in-image cells); each module
  assembled in place, Mixed_7b/7c's nested concats as adjacent slices of
  the module's buffer;
* ``_StemBf16Ops`` — the hybrid stem (Conv2d_1a .. Conv2d_4a) in bf16,
  quantized once at its output.

The stem has the JAX package's two forms: the hybrid one (the default,
``hybrid_stem=True``) or the all-int8 one (``hybrid_stem=False``: the input
quantized once at ``__input_scale__`` into 16 channels, the extra ones
zero, then the stem on ``_ForwardOps``: K1 and K2). Both calibrate on the
same float forward. :func:`_iv3_stem_quantized` dispatches on the tree's
form (``__stem__`` or not). Runtime trees hold torch tensors in the layout
of :func:`~.bn_inception_int8.tensor_tree`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels.int8 import int8_avg_pool_exclude_pad, int8_conv, int8_max_pool
from . import bn_inception_int8 as bn_int8
from .bn_inception_int8 import (QuantizedParams, _EntryDefault,
                                _fuse_entry_convs, _fused_entry, _host,
                                _InPlaceModules, _quantize_input, tensor_tree)

_SAME3 = ((1, 1), (1, 1))
_NOPAD = ((0, 0), (0, 0))
STEM_CONVS = ("Conv2d_1a_3x3", "Conv2d_2a_3x3", "Conv2d_2b_3x3",
              "Conv2d_3b_1x1", "Conv2d_4a_3x3")


def _pad_hw(pad) -> tuple:
    """``((top, bottom), (left, right))`` symmetric pads -> ``(pad_h,
    pad_w)``."""
    (t, b), (l, r) = pad
    if t != b or l != r:
        raise ValueError(f"asymmetric conv padding {pad}")
    return t, l


def fold_bn_iv3(state_dict: Mapping[str, Any],
                eps: float = 1e-3) -> Dict[str, dict]:
    """Fold frozen BN into each bias-free conv.

    ``state_dict``: the backbone's (``Mixed_5b.branch1x1.conv.weight``,
    ``Mixed_5b.branch1x1.bn.running_var``, ...). Returns the JAX package's
    tree, {"Mixed_5b/branch1x1": {"kernel": (H,W,I,O), "bias": (O,)}} numpy
    float32 with ``b = beta - mean * g/sqrt(v+eps)``, operation for
    operation.
    """
    out: Dict[str, dict] = {}
    for key, value in state_dict.items():
        if not key.endswith(".conv.weight"):
            continue
        base = key[:-len(".conv.weight")]
        bn = base + ".bn."
        if bn + "running_var" not in state_dict:
            continue
        g = _host(state_dict[bn + "weight"])
        beta = _host(state_dict[bn + "bias"])
        m = _host(state_dict[bn + "running_mean"])
        v = _host(state_dict[bn + "running_var"])
        inv = g / np.sqrt(v + eps)
        out[base.replace(".", "/")] = {
            "kernel": _host(value).transpose(2, 3, 1, 0) * inv,
            "bias": beta - m * inv,
        }
    return out


# ---------------------------------------------------------------------------
# Single topology walk, interpreted through an ops interface.
# ---------------------------------------------------------------------------


def _walk_stem(ops, x):
    """IV3 stem: input -> (35x35, 192) at 299."""
    x = ops.conv(x, "Conv2d_1a_3x3", stride=2)
    x = ops.conv(x, "Conv2d_2a_3x3")
    x = ops.conv(x, "Conv2d_2b_3x3", pad=_SAME3)
    x = ops.max_pool(x)
    x = ops.conv(x, "Conv2d_3b_1x1")
    x = ops.conv(x, "Conv2d_4a_3x3")
    return ops.max_pool(x)


def _entry_names(name: str) -> list:
    """A Mixed module's branch-ENTRY convs: the 1x1 stride-1 convs that all
    consume the module input (same tensor, same input scales), fusible into
    one conv. Mixed_6a has none."""
    if name.startswith(("Mixed_5",)):
        return [f"{name}/branch1x1", f"{name}/branch5x5_1",
                f"{name}/branch3x3dbl_1"]
    if name == "Mixed_7a":
        return [f"{name}/branch3x3_1", f"{name}/branch7x7x3_1"]
    if name.startswith("Mixed_7"):
        return [f"{name}/branch1x1", f"{name}/branch3x3_1",
                f"{name}/branch3x3dbl_1"]
    return [f"{name}/branch1x1", f"{name}/branch7x7_1",
            f"{name}/branch7x7dbl_1"]


def _walk_trunk(ops, x):
    """IV3 Mixed modules: (35x35, 192) -> features. Each module's
    ``module_slots`` name its branches' last convs (None: the passthrough
    pool) in concat order; each concat gets the slots its parts fill."""
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):     # 35x35 modules
        s = ops.module_slots(x, [f"{name}/{b}" for b in (
            "branch1x1", "branch5x5_2", "branch3x3dbl_3", "branch_pool")])
        b0, b1, b2 = ops.entry(x, name, _entry_names(name), out=s[0])
        b1 = ops.conv(b1, f"{name}/branch5x5_2", pad=((2, 2), (2, 2)),
                      out=s[1])
        b2 = ops.conv(b2, f"{name}/branch3x3dbl_2", pad=_SAME3)
        b2 = ops.conv(b2, f"{name}/branch3x3dbl_3", pad=_SAME3, out=s[2])
        b3 = ops.conv(ops.avg_pool_same(x), f"{name}/branch_pool", out=s[3])
        x = ops.concat([b0, b1, b2, b3], s)

    s = ops.module_slots(x, ["Mixed_6a/branch3x3", "Mixed_6a/branch3x3dbl_3",
                             None], stride=2, pad=0)
    b0 = ops.conv(x, "Mixed_6a/branch3x3", stride=2,      # 17x17 downsample
                  out=s[0])
    b1 = ops.conv(x, "Mixed_6a/branch3x3dbl_1")
    b1 = ops.conv(b1, "Mixed_6a/branch3x3dbl_2", pad=_SAME3)
    b1 = ops.conv(b1, "Mixed_6a/branch3x3dbl_3", stride=2, out=s[1])
    x = ops.concat([b0, b1, ops.max_pool(x, out=s[2])], s)

    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        s = ops.module_slots(x, [f"{name}/{b}" for b in (
            "branch1x1", "branch7x7_3", "branch7x7dbl_5", "branch_pool")])
        b0, b1, b2 = ops.entry(x, name, _entry_names(name), out=s[0])
        b1 = ops.conv(b1, f"{name}/branch7x7_2", pad=((0, 0), (3, 3)))
        b1 = ops.conv(b1, f"{name}/branch7x7_3", pad=((3, 3), (0, 0)),
                      out=s[1])
        b2 = ops.conv(b2, f"{name}/branch7x7dbl_2", pad=((3, 3), (0, 0)))
        b2 = ops.conv(b2, f"{name}/branch7x7dbl_3", pad=((0, 0), (3, 3)))
        b2 = ops.conv(b2, f"{name}/branch7x7dbl_4", pad=((3, 3), (0, 0)))
        b2 = ops.conv(b2, f"{name}/branch7x7dbl_5", pad=((0, 0), (3, 3)),
                      out=s[2])
        b3 = ops.conv(ops.avg_pool_same(x), f"{name}/branch_pool", out=s[3])
        x = ops.concat([b0, b1, b2, b3], s)

    s = ops.module_slots(x, ["Mixed_7a/branch3x3_2", "Mixed_7a/branch7x7x3_4",
                             None], stride=2, pad=0)
    b0, b1 = ops.entry(x, "Mixed_7a", _entry_names("Mixed_7a"))
    b0 = ops.conv(b0, "Mixed_7a/branch3x3_2", stride=2,   # 8x8 downsample
                  out=s[0])
    b1 = ops.conv(b1, "Mixed_7a/branch7x7x3_2", pad=((0, 0), (3, 3)))
    b1 = ops.conv(b1, "Mixed_7a/branch7x7x3_3", pad=((3, 3), (0, 0)))
    b1 = ops.conv(b1, "Mixed_7a/branch7x7x3_4", stride=2, out=s[1])
    x = ops.concat([b0, b1, ops.max_pool(x, out=s[2])], s)

    for name in ("Mixed_7b", "Mixed_7c"):                 # 8x8 expanded
        s = ops.module_slots(x, [f"{name}/{b}" for b in (
            "branch1x1", "branch3x3_2a", "branch3x3_2b", "branch3x3dbl_3a",
            "branch3x3dbl_3b", "branch_pool")])
        b0, b1, b2 = ops.entry(x, name, _entry_names(name), out=s[0])
        b1a = ops.conv(b1, f"{name}/branch3x3_2a", pad=((0, 0), (1, 1)),
                       out=s[1])
        b1b = ops.conv(b1, f"{name}/branch3x3_2b", pad=((1, 1), (0, 0)),
                       out=s[2])
        b1 = ops.concat([b1a, b1b], s[1:3])               # nested concat
        b2 = ops.conv(b2, f"{name}/branch3x3dbl_2", pad=_SAME3)
        b2a = ops.conv(b2, f"{name}/branch3x3dbl_3a", pad=((0, 0), (1, 1)),
                       out=s[3])
        b2b = ops.conv(b2, f"{name}/branch3x3dbl_3b", pad=((1, 1), (0, 0)),
                       out=s[4])
        b2 = ops.concat([b2a, b2b], s[3:5])
        b3 = ops.conv(ops.avg_pool_same(x), f"{name}/branch_pool", out=s[5])
        x = ops.concat([b0, b1, b2, b3], s)

    return ops.finish(x)


ENTRY_MODULES = ("Mixed_5b", "Mixed_5c", "Mixed_5d",
                 "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                 "Mixed_7a", "Mixed_7b", "Mixed_7c")


def _walk(ops, x):
    """The full IV3 topology, over an ops interface."""
    return _walk_trunk(ops, _walk_stem(ops, x))


# ---------------------------------------------------------------------------
# bf16 faces: the hybrid stem and the calibration forward (NCHW-logical,
# channels_last on the card)
# ---------------------------------------------------------------------------


class _StemBf16Ops(bn_int8._StemBf16Ops):
    """bf16 folded conv + bias + ReLU (cuDNN on the card) and the VALID 3x3
    s2 max pool; ``output_maxes``, when given, records each conv's post-ReLU
    max."""

    def conv(self, h, name, stride=1, pad=_NOPAD, out=None):
        return super().conv(h, name, stride, _pad_hw(pad))

    def max_pool(self, x, out=None):
        return F.max_pool2d(x, 3, 2)


def same_pool_counts(H: int, W: int, device=None) -> torch.Tensor:
    """(1, 1, H, W) float32 in-image cell counts of a 3x3 s1 SAME window:
    9 inside, 6 on edges, 4 in corners (``_same_pool_counts``)."""
    ones = torch.ones((1, 1, H, W), dtype=torch.float32, device=device)
    return F.avg_pool2d(ones, 3, 1, 1, divisor_override=1)


class _CalibOps(_EntryDefault, _StemBf16Ops):
    """The float forward in bf16 on the folded weights, recording every
    conv's post-ReLU max: the JAX package's ``_CalibOps``."""

    def avg_pool_same(self, x):
        """3x3 s1 SAME exclude-pad average with the JAX package's rounding:
        the window sum accumulates in bf16, cell by cell in row-major window
        order (``reduce_window(add)`` on bf16), then one bf16 division by
        the in-image cell count."""
        H, W = x.shape[2:]
        xp = F.pad(x, (1, 1, 1, 1))
        acc = torch.zeros_like(x)
        for ky in range(3):
            for kx in range(3):
                acc = acc + xp[:, :, ky:ky + H, kx:kx + W]
        return acc / same_pool_counts(H, W, x.device).to(x.dtype)

    def concat(self, parts, slots=None):
        return torch.cat(parts, dim=1)

    def finish(self, x):
        return x


def _to_bf16_nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC float frames -> bf16 NCHW-logical (channels_last on the card)."""
    h = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    if h.is_cuda:
        h = h.contiguous(memory_format=torch.channels_last)
    return h


# ---------------------------------------------------------------------------
# Host scale algebra (numpy, copied)
# ---------------------------------------------------------------------------


class _ScaleOps(_EntryDefault):
    """Host numpy scale algebra: a 'tensor' is a per-channel scale vector."""

    def __init__(self, folded, scales, out: QuantizedParams):
        self.folded = folded
        self.s = scales
        self.out = out

    def conv(self, sx_vec, name, stride=1, pad=_NOPAD, out=None):
        f = self.folded[name]
        w = np.asarray(f["kernel"], np.float64)
        sx = np.broadcast_to(np.asarray(sx_vec, np.float64), (w.shape[2],))
        w = w * sx[None, None, :, None]
        sw = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
        sw = np.where(sw == 0, 1.0, sw)
        so = self.s[name]
        self.out[name] = {
            "wq": np.clip(np.round(w / sw), -127, 127).astype(np.int8),
            "m": np.asarray(sw / so, np.float32),
            "bq": np.asarray(np.asarray(f["bias"], np.float64) / so,
                             np.float32),
        }
        return np.full(w.shape[3], so)

    def max_pool(self, sx_vec, out=None):
        return sx_vec

    def avg_pool_same(self, sx_vec):
        return sx_vec

    def concat(self, parts, slots=None):
        return np.concatenate(parts)

    def finish(self, sx_vec):
        self.out["__feat_scale__"] = np.asarray(sx_vec, np.float32)
        return self.out


# ---------------------------------------------------------------------------
# Runtime face (int8 NHWC through K1-K3)
# ---------------------------------------------------------------------------


class _ForwardOps(_InPlaceModules, _EntryDefault):
    """The int8 runtime: int8 NHWC tensors, requantizing conv epilogues,
    each module assembled in place."""

    def __init__(self, qe: QuantizedParams):
        self.qe = qe

    def entry(self, xq, module, names, out=None):
        if module not in self.qe.get("__entry__", ()):
            return super().entry(xq, module, names, out)
        return _fused_entry(int8_conv, self.qe, xq, module, names, out)

    def conv(self, xq, name, stride=1, pad=_NOPAD, out=None):
        layer = self.qe[name]
        return int8_conv(xq, layer["wq"], layer["m"], layer["bq"],
                         stride=stride, pad=_pad_hw(pad), out=out)

    def max_pool(self, x, out=None):
        return int8_max_pool(x, 3, 2, _NOPAD, out=out)

    def avg_pool_same(self, x):
        return int8_avg_pool_exclude_pad(x, 3, 1, 1)

    def finish(self, x):
        return x.float().mean(dim=(1, 2)) * self.qe["__feat_scale__"]


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def _calibration_maxes_iv3(stem: dict, x: torch.Tensor) -> Dict[str, float]:
    """Every conv's post-ReLU output max of the bf16 float forward (+ the
    input max). ``stem``: folded OIHW weights of every conv; one host
    transfer at the end."""
    ops = _CalibOps(stem, output_maxes={"input": x.abs().amax().float()})
    _walk(ops, _to_bf16_nchw(x))
    names = list(ops.output_maxes)
    values = torch.stack([ops.output_maxes[n] for n in names]).cpu().tolist()
    return dict(zip(names, values))


def _torch_folded(folded: dict, device) -> dict:
    """Folded HWIO numpy weights -> OIHW float32 tensors on ``device``."""
    return {n: {"kernel": torch.from_numpy(f["kernel"])
                .permute(3, 2, 0, 1).contiguous().to(device),
                "bias": torch.from_numpy(f["bias"]).to(device)}
            for n, f in folded.items()}


def quantize_iv3_e2e(folded: dict, maxes: Dict[str, float],
                     hybrid_stem: bool = True) -> QuantizedParams:
    """The e2e tree from calibration maxes. With ``hybrid_stem``: the
    stem's folded weights (``__stem__``, bf16 at run time) quantized once
    at the Conv2d_4a output (``__stem_scale__``), the trunk through
    ``_ScaleOps``; without: the whole net through ``_ScaleOps`` from the
    input's scale on each of the stem conv's input channels. Then the fused
    entry convs. Returns the runtime tensor tree on the CPU."""
    scales = {k: max(float(v), 1e-8) / 127.0 for k, v in maxes.items()}
    qe: Dict[str, Any] = {"__input_scale__": np.asarray(scales["input"],
                                                        np.float32)}
    if hybrid_stem:
        qe["__stem__"] = {n: {"kernel": folded[n]["kernel"],
                              "bias": folded[n]["bias"]} for n in STEM_CONVS}
        s4a = scales["Conv2d_4a_3x3"]
        qe["__stem_scale__"] = np.asarray(s4a, np.float32)
        cin_trunk = folded["Conv2d_4a_3x3"]["kernel"].shape[3]    # 192
        _walk_trunk(_ScaleOps(folded, scales, qe), np.full(cin_trunk, s4a))
    else:
        # input channels from the stem conv's kernel (3 RGB / 10 Flow)
        cin = folded["Conv2d_1a_3x3"]["kernel"].shape[2]
        _walk(_ScaleOps(folded, scales, qe), np.full(cin, scales["input"]))
    qe["__entry__"] = _fuse_entry_convs(
        qe, ((m, _entry_names(m)) for m in ENTRY_MODULES))
    return tensor_tree(qe)


def calibrate_e2e_iv3(state_dict: Mapping[str, Any],
                      sample_frames: torch.Tensor,
                      hybrid_stem: bool = True) -> QuantizedParams:
    """Calibrate + build the e2e-quantized IV3 backbone.

    ``sample_frames``: representative NORMALIZED NHWC frames on the device
    the calibration pass should run on (any spatial size: VALID semantics).
    The calibration face is the float forward, so Conv2d_4a's max is exactly
    the tensor the hybrid runtime quantizes (a max pool keeps the max).
    ``hybrid_stem``: the bf16 stem (the default) or the all-int8 one
    (:func:`quantize_iv3_e2e`), from the same maxes.
    """
    folded = fold_bn_iv3(state_dict)
    with torch.no_grad():
        maxes = _calibration_maxes_iv3(
            _torch_folded(folded, sample_frames.device),
            sample_frames)
    return quantize_iv3_e2e(folded, maxes, hybrid_stem=hybrid_stem)


def _iv3_stem_quantized(qe: QuantizedParams, x: torch.Tensor) -> torch.Tensor:
    """Normalized NHWC frames -> int8 NHWC trunk input (35x35 at 299), any
    spatial size. Hybrid tree (``__stem__``): the bf16 folded stem,
    quantized once at its output. All-int8 tree: the input quantized at
    ``__input_scale__`` into Conv2d_1a's padded channels, then the int8
    stem on K1 and K2."""
    if "__stem__" not in qe:
        xq = _quantize_input(x, qe["__input_scale__"],
                             qe["Conv2d_1a_3x3"]["wq"].shape[-1])
        return _walk_stem(_ForwardOps(qe), xq)
    h = _walk_stem(_StemBf16Ops(qe["__stem__"]), _to_bf16_nchw(x))
    hq = torch.clamp(torch.round(h.float() / qe["__stem_scale__"]), 0, 127)
    return hq.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def iv3_trunk(qe: QuantizedParams, h: torch.Tensor) -> torch.Tensor:
    """int8 trunk input (N, h, w, 192) -> (N, 2048) f32 features."""
    return _walk_trunk(_ForwardOps(qe), h)


def inception_v3_int8_e2e_features(qe: QuantizedParams,
                                   x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) normalized frames -> (N, 2048) features, int8 end to
    end from the stem output to the final concat."""
    return iv3_trunk(qe, _iv3_stem_quantized(qe, x))


def iv3_stem_feature_hw(size: int) -> int:
    """Trunk-input spatial size of the IV3 stem for one input dim.

    Conv2d_1a 3x3 s2 VALID -> 2a 3x3 VALID -> 2b SAME -> pool 3x3 s2 VALID
    -> 3b/4a (1x1, 3x3 VALID) -> pool 3x3 s2 VALID; overall stride 8
    (299 -> 35)."""
    n = (size - 3) // 2 + 1
    n = n - 2
    n = (n - 3) // 2 + 1
    n = n - 2
    n = (n - 3) // 2 + 1
    return n


def inception_v3_int8_e2e_features_sharedstem(
        qe: QuantizedParams, xn: torch.Tensor, flip_src: torch.Tensor,
        crop_size: int) -> torch.Tensor:
    """Shared-stem 10-crop IV3 features: the stem runs once per frame and
    its flip, and the crop windows are sliced on the stride-8 trunk-input
    grid (``quantize.sharedstem_crop_windows``). Returns (10*N, 2048) f32
    features, crop-major."""
    from .quantize import sharedstem_crop_windows

    h = sharedstem_crop_windows(lambda x: _iv3_stem_quantized(qe, x),
                                iv3_stem_feature_hw, xn, flip_src, crop_size)
    return iv3_trunk(qe, h)

