"""Int8 BNInception for scoring (torch port).

Port of ``action_detection_tpu/models/backbones/bn_inception_int8.py``, its
two int8 modes:

* **Host scale algebra** (numpy, copied): :func:`fold_bn`,
  :func:`quantize_backbone`, :func:`quantize_backbone_e2e`, ``_ScaleOps``
  and ``_fuse_entry_convs``. Every conv's weights absorb its input's
  per-channel activation scales and quantize per output channel; the
  epilogue ``m = sw/so``, ``bq = bias/so`` requantizes each conv's output to
  its own calibrated scale.
* **One topology walk** (:func:`_walk_stem`, :func:`_walk_trunk`, the
  JAX package's) interpreted by several ops faces, so branch order and pool
  choices are written once. The trunk's walk also asks each face for a
  module's output slots (``module_slots``) and hands each branch's last op
  its slot (``out=``): the int8 face assembles the module in place, the
  others return no slots and concatenate.
* **e2e, the scoring default**: ``_E2EOps`` (int8 activations end to end
  through the hand-written kernels K1-K3 of ``kernels/int8.py``, with the
  fused branch-entry conv), calibrated by :func:`calibrate_e2e`. Its stem
  comes in two forms, as in the JAX package: the hybrid stem (the default,
  ``hybrid_stem=True``; ``_StemBf16Ops``, bf16 on cuDNN, quantized once at
  its output) or the all-int8 stem (``hybrid_stem=False``: the input
  quantized once at ``__input_scale__`` into 16 channels, the extra ones
  zero, then the stem's convs and pools on K1 and K2). A tree carries its
  stem's form (``__stem__`` or not), and :func:`_e2e_stem_quantized`
  dispatches on it, so a ``prequantized`` all-int8 tree scores as JAX
  scores it.
* **perlayer** (``--int8_mode perlayer``): ``_PerLayerOps``, bf16
  activations and every conv, the stem's included, in int8 through K1's
  bf16 dequantizing epilogue after a per-tensor activation quantize
  (dynamic ``max|x|/127``, or static scales from
  :func:`calibrate_activation_scales`); bf16 Caffe-ceil max pools and
  include-pad avg pools as torch ops (:func:`bninception_int8_features`).
  The same face, with dynamic scales and output maxes recorded, is the
  e2e calibration pass (for the all-int8 stem, its stem too).
* :func:`quantization_report`: int8 against float features (and fused
  scores) on real frames, the check to run before deploying ``--int8``.

Runtime trees hold torch tensors: conv weights ``wq`` repacked to
``(O, KH, KW, C)`` int8 for K1 (a stem conv's C padded with zero channels
to a multiple of 16, K1's 16-byte rule), ``m``/``bq`` float32, the hybrid
stem's folded kernels bf16 OIHW (see :func:`tensor_tree`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ...kernels.int8 import (channel_slots, concat_channels, int8_avg_pool,
                             int8_conv, int8_max_pool)
from .bn_inception import (_INCEPTION_CFG, max_pool, pool_pads,
                           stem_feature_hw)

QuantizedParams = Dict[str, Any]
STEM_CONVS = ("conv1_7x7_s2", "conv2_3x3_reduce", "conv2_3x3")


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def fold_bn(state_dict: Mapping[str, Any], eps: float = 1e-5) -> dict:
    """Fold frozen BN into each conv: w' = w * g/sqrt(v+eps),
    b' = (b-m)*g/sqrt(v+eps) + beta.

    ``state_dict``: the backbone's (``<layer>.weight`` ...). Returns
    {layer_name: {"kernel": (H,W,I,O), "bias": (O,)}} numpy float32 for every
    conv that has a sibling ``<name>_bn`` — the JAX package's layout, so the
    algebra below is the JAX package's, operation for operation.
    """
    out = {}
    for key, value in state_dict.items():
        if not key.endswith(".weight"):
            continue
        name = key[:-len(".weight")]
        bn = name + "_bn"
        if bn + ".running_var" not in state_dict:
            continue
        kernel = _host(value)
        if kernel.ndim != 4:
            continue
        g = _host(state_dict[bn + ".weight"])
        beta = _host(state_dict[bn + ".bias"])
        m = _host(state_dict[bn + ".running_mean"])
        v = _host(state_dict[bn + ".running_var"])
        inv = g / np.sqrt(v + eps)
        w = kernel.transpose(2, 3, 1, 0) * inv
        b = (_host(state_dict[name + ".bias"]) - m) * inv + beta
        out[name] = {"kernel": w, "bias": b}
    return out


def quantize_backbone(state_dict: Mapping[str, Any],
                      folded: dict = None) -> QuantizedParams:
    """BN-fold then per-output-channel int8-quantize every conv (the
    per-layer tree; the stem conv's weights padded as :func:`_pack_wq`
    pads them)."""
    folded = folded if folded is not None else fold_bn(state_dict)
    q: QuantizedParams = {}
    for name, leaf in folded.items():
        w = leaf["kernel"]
        sw = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0        # (O,)
        sw = np.where(sw == 0, 1.0, sw)
        wq = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
        q[name] = {"wq": _pack_wq(wq),
                   "sw": torch.from_numpy(np.asarray(sw, np.float32)),
                   "bias": torch.from_numpy(np.asarray(leaf["bias"],
                                                       np.float32))}
    return q


# ---------------------------------------------------------------------------
# Single topology walk, interpreted through an ops interface.
# ---------------------------------------------------------------------------


def _walk_stem(ops, x):
    x = ops.conv(x, "conv1_7x7_s2", stride=2, pad=3)
    x = ops.max_pool(x, 3, 2, ceil=True)
    x = ops.conv(x, "conv2_3x3_reduce")
    x = ops.conv(x, "conv2_3x3", pad=1)
    return ops.max_pool(x, 3, 2, ceil=True)


def _entry_names(name: str, c1) -> list:
    """A module's branch-ENTRY convs: the 1x1s that all consume the module
    input (same tensor, same input scales) — fusible into one conv."""
    return (([f"{name}_1x1"] if c1 is not None else [])
            + [f"{name}_3x3_reduce", f"{name}_double_3x3_reduce"])


def _walk_trunk(ops, x):
    for (name, c1, _c3r, _c3, _d3r, _d31, _d32, _proj, pool, stride) \
            in _INCEPTION_CFG:
        # each branch's last conv or pool (None: the passthrough pool)
        ends = ([f"{name}_1x1"] if c1 is not None else []) + [
            f"{name}_3x3", f"{name}_double_3x3_2",
            f"{name}_pool_proj" if stride == 1 else None]
        slots = ops.module_slots(x, ends, stride)
        heads = ops.entry(x, name, _entry_names(name, c1),
                          out=slots[0] if c1 is not None else None)
        branches = list(heads[:1]) if c1 is not None else []
        i = 1 if c1 is not None else 0
        b3 = ops.conv(heads[i], f"{name}_3x3", stride=stride, pad=1,
                      out=slots[-3])
        branches.append(b3)
        bd = ops.conv(heads[i + 1], f"{name}_double_3x3_1", pad=1)
        bd = ops.conv(bd, f"{name}_double_3x3_2", stride=stride, pad=1,
                      out=slots[-2])
        branches.append(bd)
        if stride == 1:
            bp = (ops.avg_pool(x, 3, 1, 1) if pool == "avg"
                  else ops.max_pool(x, 3, 1, pad=1))
            branches.append(ops.conv(bp, f"{name}_pool_proj", out=slots[-1]))
        else:
            # stride-2 modules: passthrough ceil-mode max pool branch
            branches.append(ops.max_pool(x, 3, 2, ceil=True, out=slots[-1]))
        x = ops.concat(branches, slots)
    return x


class _EntryDefault:
    """Defaults of the walks' faces: the entry convs run separately, and a
    module's branches write tensors of their own, which ``concat`` joins
    (no slots: every ``out=`` the walk hands on is None)."""

    def entry(self, x, module, names, out=None):
        """The entry convs' outputs; the first written into ``out``."""
        return [self.conv(x, n, out=out if i == 0 else None)
                for i, n in enumerate(names)]

    def module_slots(self, x, ends, stride=1, pad=1):
        """Where a module's branches write their outputs, one slot a name of
        ``ends`` (each branch's last conv, in concat order; None for a
        passthrough pool): here None for each."""
        return [None] * len(ends)


class _InPlaceModules:
    """The int8 faces' module assembly: one int8 buffer a module, whose
    channel slices the branches' last K1 or K2 launches write
    (``kernels.int8.channel_slots``), so the concat, handed the slots, is
    a view (``concat_channels``). The walk decides from the widths alone:
    where one is not a multiple of 16 the branches write tensors of their
    own and the concat copies; both counted (``concat_in_place``,
    ``concat_copied``)."""

    def module_slots(self, x, ends, stride=1, pad=1):
        """``ends``' slots in the module's buffer: each a conv's output
        channels (None: the input's, a passthrough pool's). The module's
        output grid is that of a 3x3 window at ``stride`` over ``pad``
        (every branch's last op keeps it)."""
        N, H, W, C = x.shape
        widths = [C if n is None else self.qe[n]["wq"].shape[0]
                  for n in ends]
        grid = (N, (H + 2 * pad - 3) // stride + 1,
                (W + 2 * pad - 3) // stride + 1)
        return channel_slots(grid, widths, x.device) or [None] * len(ends)

    def concat(self, parts, slots=None):
        return concat_channels(parts, slots)


# ---------------------------------------------------------------------------
# Host scale algebra (numpy; 'tensors' are per-channel scale vectors)
# ---------------------------------------------------------------------------


def quantize_backbone_e2e(state_dict: Mapping[str, Any],
                          out_maxes: Dict[str, float],
                          hybrid_stem: bool = True,
                          folded: dict = None) -> QuantizedParams:
    """BN-fold + int8-quantize with input-scale folding for e2e activations.

    ``out_maxes``: {"input": max|normalized input|, conv_name: max post-ReLU
    conv output} from :func:`_e2e_output_maxes`. With ``hybrid_stem`` the
    stem (conv1..conv2_3x3) stays bf16 on its folded weights (``__stem__``)
    and is quantized once at its output (``__stem_scale__``); without, the
    scale walk starts at the input's scalar scale and the stem's convs are
    int8 like the trunk's. Every int8 conv absorbs its input scales and
    quantizes per output channel. ``__feat_scale__`` is the final concat's
    per-channel scale vector, applied after global average pooling.
    Returns the runtime tensor tree (:func:`tensor_tree`) on the CPU.
    """
    folded = folded if folded is not None else fold_bn(state_dict)
    s = {k: max(float(v), 1e-8) / 127.0 for k, v in out_maxes.items()}
    qe: Dict[str, Any] = {}
    ops = _ScaleOps(folded, s, qe)

    if hybrid_stem:
        qe["__stem__"] = {name: {"kernel": folded[name]["kernel"],
                                 "bias": folded[name]["bias"]}
                          for name in STEM_CONVS}
        qe["__stem_scale__"] = np.asarray(s["conv2_3x3"], np.float32)
        sx = np.full(folded["conv2_3x3"]["kernel"].shape[3], s["conv2_3x3"])
    else:
        sx = _walk_stem(ops, np.asarray(s["input"]))
    sx = _walk_trunk(ops, sx)

    qe["__input_scale__"] = np.asarray(s["input"], np.float32)
    qe["__feat_scale__"] = np.asarray(sx, np.float32)
    qe["__entry__"] = _fuse_entry_convs(qe, (
        (name, _entry_names(name, c1))
        for (name, c1, *_r) in _INCEPTION_CFG))
    return tensor_tree(qe)


def _fuse_entry_convs(qe: QuantizedParams, groups) -> Dict[str, dict]:
    """Concat each module's entry-conv tensors along the output-channel axis.

    Exact by construction: the entry convs share the input (hence the same
    folded input scales), accumulate in s32, and the requantizing epilogue is
    per output channel — so conv+split is bit-identical to the separate
    convs. The per-conv entries stay in the tree: they carry the split
    shapes.
    """
    return {
        module: {
            "wq": np.concatenate([qe[n]["wq"] for n in names], axis=3),
            "m": np.concatenate([qe[n]["m"] for n in names]),
            "bq": np.concatenate([qe[n]["bq"] for n in names]),
        }
        for module, names in groups}


class _ScaleOps(_EntryDefault):
    """Host scale algebra: 'tensors' are per-channel activation scale vectors.

    ``conv`` absorbs its input scales into the weights, int8-quantizes them
    per output channel into ``out``, and returns the conv's own (uniform)
    output scale vector; pools are scale-preserving per channel.
    """

    def __init__(self, folded: dict, s: Dict[str, float],
                 out: QuantizedParams):
        self.folded = folded
        self.s = s
        self.out = out

    def conv(self, sx, name, stride=1, pad=0, out=None):
        w = np.asarray(self.folded[name]["kernel"], np.float64)
        sx_vec = np.broadcast_to(np.asarray(sx, np.float64), (w.shape[2],))
        w = w * sx_vec[None, None, :, None]
        sw = np.max(np.abs(w), axis=(0, 1, 2)) / 127.0
        sw = np.where(sw == 0, 1.0, sw)
        wq = np.clip(np.round(w / sw), -127, 127).astype(np.int8)
        so = self.s[name]
        self.out[name] = {"wq": wq,
                          "m": np.asarray(sw / so, np.float32),
                          "bq": np.asarray(
                              np.asarray(self.folded[name]["bias"],
                                         np.float64) / so, np.float32)}
        return np.full(w.shape[3], so)

    def max_pool(self, sx, kernel, stride, ceil=False, pad=0, out=None):
        return sx

    def avg_pool(self, sx, kernel, stride, pad):
        return sx

    def concat(self, parts, slots=None):
        return np.concatenate([np.atleast_1d(p) for p in parts])


def _pack_wq(wq: np.ndarray) -> torch.Tensor:
    """HWIO int8 -> (O, KH, KW, C) contiguous, the layout K1 reads. A conv
    whose input channels are not a multiple of 16 (a stem conv: 3, 10 or
    15) gets zero weight channels up to the next one; its input is
    quantized into as many channels, the extra ones zero
    (:func:`_quantize_input`), so the s32 sums are the unpadded conv's."""
    wq = np.pad(wq, ((0, 0), (0, 0), (0, -wq.shape[2] % 16), (0, 0)))
    return torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 0, 1, 2)))


def _f32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def tensor_tree(qe: Dict[str, Any]) -> QuantizedParams:
    """A numpy e2e tree in the JAX package's layout -> runtime tensors.

    Conv entries: ``wq`` HWIO int8 -> (O, KH, KW, C) int8
    (:func:`_pack_wq`), ``m``/``bq`` float32. ``__stem__`` (a hybrid-stem
    tree): folded HWIO float32 -> bf16 OIHW (rounded to nearest even, as
    ``jnp.asarray(..., bfloat16)`` does). Scalars and the feature scale
    stay float32.
    """
    def layer(v):
        return {"wq": _pack_wq(np.asarray(v["wq"], np.int8)),
                "m": _f32(v["m"]), "bq": _f32(v["bq"])}

    out: QuantizedParams = {}
    for k, v in qe.items():
        if k == "__stem__":
            out[k] = {n: {"kernel": _f32(f["kernel"]).permute(3, 2, 0, 1)
                          .contiguous().to(torch.bfloat16),
                          "bias": _f32(f["bias"]).to(torch.bfloat16)}
                      for n, f in v.items()}
        elif k == "__entry__":
            out[k] = {mod: layer(f) for mod, f in v.items()}
        elif k.startswith("__"):
            out[k] = _f32(v)
        else:
            out[k] = layer(v)
    return out


def tree_to(tree, device) -> Any:
    """Move every tensor of a (nested dict) tree to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


# ---------------------------------------------------------------------------
# Runtime faces (torch tensors)
# ---------------------------------------------------------------------------


def _fused_entry(conv, qe: QuantizedParams, xq: torch.Tensor, module: str,
                 names, out=None):
    """Branch-entry fusion: one ``conv`` (K1's wrapper) over the module's
    concatenated 1x1 weights, bit-identical to the separate convs (shared
    input scales, exact s32 sums, per-output-channel epilogue). The heads
    are channel slices that K1 reads in place; with ``out`` the first head
    is written there (the module's buffer) and the others into a tensor of
    their own."""
    f = qe["__entry__"][module]
    widths = [int(qe[n]["wq"].shape[0]) for n in names]
    if out is None:
        return torch.split(conv(xq, f["wq"], f["m"], f["bq"]), widths,
                           dim=-1)
    rest = xq.new_empty(tuple(xq.shape[:3]) + (sum(widths[1:]),))
    conv(xq, f["wq"], f["m"], f["bq"], out=(out, rest))
    return [out, *torch.split(rest, widths[1:], dim=-1)]


class _E2EOps(_InPlaceModules, _EntryDefault):
    """int8 NHWC activations end to end, through kernels K1-K3, each
    module assembled in place."""

    def __init__(self, qe: QuantizedParams):
        self.qe = qe

    def conv(self, xq, name, stride=1, pad=0, out=None):
        layer = self.qe[name]
        return int8_conv(xq, layer["wq"], layer["m"], layer["bq"],
                         stride=stride, pad=pad, out=out)

    def entry(self, xq, module, names, out=None):
        if module not in self.qe.get("__entry__", ()):
            return super().entry(xq, module, names, out)
        return _fused_entry(int8_conv, self.qe, xq, module, names, out)

    def max_pool(self, x, kernel, stride, ceil=False, pad=0, out=None):
        return int8_max_pool(x, kernel, stride,
                             pool_pads(x.shape[1], x.shape[2], kernel, stride,
                                       ceil, pad), out=out)

    def avg_pool(self, x, kernel, stride, pad):
        return int8_avg_pool(x, kernel, stride, pad)


class _StemBf16Ops:
    """bf16 folded-weight stem on NCHW-logical tensors (cuDNN on the card).

    ``stem`` maps each stem conv to ``{"kernel": OIHW, "bias": (O,)}``
    (any float dtype; rounded to bf16 here). ``output_maxes``, when given,
    records each conv's post-ReLU max.
    """

    def __init__(self, stem: dict, output_maxes: Dict[str, Any] = None):
        self.stem = stem
        self.output_maxes = output_maxes

    def conv(self, h, name, stride=1, pad=0):
        f = self.stem[name]
        y = F.conv2d(h, f["kernel"].to(torch.bfloat16), stride=stride,
                     padding=pad)
        out = torch.clamp_min(
            y + f["bias"].to(torch.bfloat16).view(1, -1, 1, 1), 0)
        if self.output_maxes is not None:
            self.output_maxes[name] = out.amax().float()
        return out

    def max_pool(self, x, kernel, stride, ceil=False, pad=0):
        return max_pool(x, kernel, stride, ceil=ceil, pad=pad)


def _stem_bf16(stem: dict, x: torch.Tensor,
               output_maxes: Dict[str, Any] = None) -> torch.Tensor:
    """NHWC float frames -> the bf16 stem output, NCHW-logical."""
    h = x.to(torch.bfloat16).permute(0, 3, 1, 2)
    if h.is_cuda:
        h = h.contiguous(memory_format=torch.channels_last)
    return _walk_stem(_StemBf16Ops(stem, output_maxes), h)


def _e2e_stem_quantized(qe: QuantizedParams, x: torch.Tensor) -> torch.Tensor:
    """Normalized NHWC frames -> int8 NHWC trunk input, at any spatial size.

    Hybrid tree (``__stem__``): the bf16 folded stem, quantized once at its
    output. All-int8 tree: the input quantized at ``__input_scale__`` into
    the stem conv's padded channels, then the int8 stem on K1 and K2."""
    if "__stem__" not in qe:
        xq = _quantize_input(x, qe["__input_scale__"],
                             qe["conv1_7x7_s2"]["wq"].shape[-1])
        return _walk_stem(_E2EOps(qe), xq)
    h = _stem_bf16(qe["__stem__"], x)
    hq = torch.clamp(torch.round(h.float() / qe["__stem_scale__"]), 0, 127)
    return hq.to(torch.int8).permute(0, 2, 3, 1).contiguous()


def _e2e_trunk(qe: QuantizedParams, h: torch.Tensor) -> torch.Tensor:
    """int8 trunk input (N, h, w, 192) -> (N, 1024) f32 features."""
    h = _walk_trunk(_E2EOps(qe), h)
    return h.float().mean(dim=(1, 2)) * qe["__feat_scale__"]


def bninception_int8_e2e_features(qe: QuantizedParams,
                                  x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) normalized frames -> (N, 1024) features, int8 end to end
    from the stem output to the final concat; one dequantization after the
    global average pool."""
    return _e2e_trunk(qe, _e2e_stem_quantized(qe, x))


def bninception_int8_e2e_features_sharedstem(
        qe: QuantizedParams, xn: torch.Tensor, flip_src: torch.Tensor,
        crop_size: int) -> torch.Tensor:
    """Shared-stem 10-crop features: the stem runs once per FRAME (+ once per
    flipped frame) and the 10 crop windows are sliced from the stride-8
    trunk-input grid (see ``quantize.sharedstem_crop_windows``).

    Returns (10*N, 1024) f32 features, crop-major in exactly
    ``device_oversample_normed``'s crop order.
    """
    from .quantize import sharedstem_crop_windows

    h = sharedstem_crop_windows(lambda x: _e2e_stem_quantized(qe, x),
                                stem_feature_hw, xn, flip_src, crop_size)
    return _e2e_trunk(qe, h)


# ---------------------------------------------------------------------------
# perlayer: bf16 activations, int8 convs (runtime and calibration)
# ---------------------------------------------------------------------------


def _quantize_input(x: torch.Tensor, sx: torch.Tensor,
                    channels: int) -> torch.Tensor:
    """``clip(round(x / sx), -127, 127)`` as int8, in ``channels >=
    x.shape[-1]`` channels whose extra ones are zero (the padded stem
    conv's input)."""
    xq = torch.clamp(torch.round(x.float() / sx), -127, 127).to(torch.int8)
    if channels == x.shape[-1]:
        return xq
    out = torch.zeros(x.shape[:-1] + (channels,), dtype=torch.int8,
                      device=x.device)
    out[..., :x.shape[-1]] = xq
    return out


class _PerLayerOps(_EntryDefault):
    """bf16 NHWC activations, per-layer int8 convs.

    Each conv quantizes its input with a per-tensor scale, static
    (``act_scales[name]``) or dynamic (``max|x|/127``), and runs K1 with the
    bf16 epilogue ``bf16(max(y*(sx*sw) + b, 0))``. ``input_maxes`` /
    ``output_maxes``, when given, record each conv's input |max| (the
    per-layer static-scale calibration) / post-ReLU output max (the e2e
    calibration).
    """

    def __init__(self, q: QuantizedParams, act_scales: Dict[str, Any] = None,
                 input_maxes: Dict[str, Any] = None,
                 output_maxes: Dict[str, Any] = None):
        self.q = q
        self.s = act_scales or {}
        self.input_maxes = input_maxes
        self.output_maxes = output_maxes

    def quantize(self, x, name):
        """Conv ``name``'s int8 input and its scale ``sx``."""
        sx = self.s.get(name)
        if sx is None or self.input_maxes is not None:
            m = x.abs().amax().float()
            if self.input_maxes is not None:
                self.input_maxes[name] = m
            if sx is None:
                sx = torch.clamp_min(m / 127.0, 1e-8)
        return _quantize_input(x, sx, self.q[name]["wq"].shape[-1]), sx

    def conv(self, x, name, stride=1, pad=0, out=None):
        layer = self.q[name]
        xq, sx = self.quantize(x, name)
        out = int8_conv(xq, layer["wq"], sx * layer["sw"], layer["bias"],
                        stride=stride, pad=pad, out_dtype=torch.bfloat16)
        if self.output_maxes is not None:
            # post-ReLU, so max == |max|
            self.output_maxes[name] = out.amax().float()
        return out

    def max_pool(self, x, kernel, stride, ceil=False, pad=0, out=None):
        return max_pool(x.permute(0, 3, 1, 2), kernel, stride, ceil=ceil,
                        pad=pad).permute(0, 2, 3, 1)

    def avg_pool(self, x, kernel, stride, pad):
        return _avg_pool_bf16(x, kernel, stride, pad)

    def concat(self, parts, slots=None):
        return torch.cat(parts, dim=-1)


def bninception_int8_features(q: QuantizedParams, x: torch.Tensor,
                              act_scales: Dict[str, Any] = None
                              ) -> torch.Tensor:
    """(N, H, W, C) normalized frames -> (N, 1024) features, every conv in
    int8 (``--int8_mode perlayer``). ``act_scales``: optional static
    per-layer scales from :func:`calibrate_activation_scales`; without,
    each conv takes its input's dynamic scale. The global mean is taken in
    float32 and rounded to bf16, as ``jnp.mean`` of a bf16 tensor is."""
    ops = _PerLayerOps(q, act_scales=act_scales)
    h = _walk_trunk(ops, _walk_stem(ops, x.to(torch.bfloat16)))
    return h.float().mean(dim=(1, 2)).to(torch.bfloat16).float()


def _calibration_maxes(q: QuantizedParams,
                       sample_frames: torch.Tensor) -> Dict[str, Any]:
    """The dynamic-scale per-layer forward, recording each conv input's
    |max| (device scalars)."""
    maxes: Dict[str, Any] = {}
    ops = _PerLayerOps(q, input_maxes=maxes)
    _walk_trunk(ops, _walk_stem(ops, sample_frames.to(torch.bfloat16)))
    return maxes


def calibrate_activation_scales(q: QuantizedParams,
                                sample_frames: torch.Tensor
                                ) -> Dict[str, torch.Tensor]:
    """One calibration pass over representative NORMALIZED frames ->
    ``{conv: float32 scale}`` to pass as ``act_scales``: ``max(m, 1e-8) /
    127`` of each conv input's max ``m``, in float64 then rounded to
    float32, as the JAX package computes it. One host transfer; the scales
    come back on the frames' device."""
    with torch.no_grad():
        maxes = _calibration_maxes(q, sample_frames)
    names = list(maxes)
    values = torch.stack([maxes[n] for n in names]).cpu().tolist()
    return {n: torch.tensor(max(m, 1e-8) / 127.0, dtype=torch.float32,
                            device=sample_frames.device)
            for n, m in zip(names, values)}


def _avg_pool_bf16(x: torch.Tensor, kernel: int, stride: int,
                   pad: int) -> torch.Tensor:
    """Count-include-pad average pool of a bf16 NHWC tensor with the JAX
    package's rounding: the window sum accumulates IN bf16, cell by cell in
    row-major window order (what ``reduce_window(add)`` on bf16 computes),
    then one bf16 division by the window size."""
    N, H, W, C = x.shape
    xp = F.pad(x, (0, 0, pad, pad, pad, pad))
    Ho = (H + 2 * pad - kernel) // stride + 1
    Wo = (W + 2 * pad - kernel) // stride + 1
    acc = torch.zeros((N, Ho, Wo, C), dtype=x.dtype, device=x.device)
    for ky in range(kernel):
        for kx in range(kernel):
            acc = acc + xp[:, ky:ky + stride * (Ho - 1) + 1:stride,
                           kx:kx + stride * (Wo - 1) + 1:stride, :]
    return acc / float(kernel * kernel)


# ---------------------------------------------------------------------------
# e2e calibration
# ---------------------------------------------------------------------------


def _e2e_output_maxes(q: QuantizedParams, x: torch.Tensor,
                      stem: dict = None) -> Dict[str, float]:
    """Calibration pass: each conv's post-ReLU OUTPUT max (+ the input max).

    With ``stem`` (folded OIHW weights of the stem convs: the hybrid-stem
    calibration) the stem runs in bf16 on them, as the hybrid runtime does,
    so conv2_3x3's max is measured on the tensor the runtime quantizes;
    without, the stem runs the int8 proxy, as the trunk always does: the
    per-layer dynamic-scale int8 forward. One host transfer at the end.
    """
    maxes: Dict[str, Any] = {"input": x.abs().amax().float()}
    ops = _PerLayerOps(q, output_maxes=maxes)
    if stem is not None:
        h = _stem_bf16(stem, x, output_maxes=maxes)
        h = h.permute(0, 2, 3, 1).contiguous()
    else:
        h = _walk_stem(ops, x.to(torch.bfloat16))
    _walk_trunk(ops, h)
    names = list(maxes)
    values = torch.stack([maxes[n] for n in names]).cpu().tolist()
    return dict(zip(names, values))


def calibrate_e2e(state_dict: Mapping[str, Any],
                  sample_frames: torch.Tensor,
                  hybrid_stem: bool = True) -> QuantizedParams:
    """Calibrate + build the e2e-quantized backbone in one step.

    ``sample_frames``: representative NORMALIZED NHWC frames on the device
    the calibration pass should run on (multi-video spread: an activation
    exceeding its calibrated max saturates at 127). ``hybrid_stem``: the
    bf16 stem (the default) or the all-int8 one
    (:func:`quantize_backbone_e2e`). Returns the runtime tree on the CPU.
    """
    folded = fold_bn(state_dict)      # folded once, shared below
    dev = sample_frames.device
    q0 = tree_to(quantize_backbone(state_dict, folded=folded), dev)
    stem = None
    if hybrid_stem:
        stem = {k: {"kernel": _f32(folded[k]["kernel"]).permute(3, 2, 0, 1)
                    .contiguous().to(dev),
                    "bias": _f32(folded[k]["bias"]).to(dev)}
                for k in STEM_CONVS}
    with torch.no_grad():
        maxes = _e2e_output_maxes(q0, sample_frames, stem)
    return quantize_backbone_e2e(state_dict, maxes, hybrid_stem=hybrid_stem,
                                 folded=folded)


def quantization_report(backbone, state_dict: Mapping[str, Any],
                        frames: torch.Tensor, fused_kernel=None,
                        fused_bias=None, layout=None,
                        mode: str = "perlayer") -> Dict[str, float]:
    """int8 against float divergence on real inputs, the check to run with
    a converted reference checkpoint before deploying ``--int8``.

    ``backbone``: the port's float BNInception module, run on
    ``state_dict`` (its weights, e.g. ``backbone.state_dict()``) in eval
    mode with TF32 off; ``frames``: NORMALIZED NHWC frames, on the device
    everything runs on. ``mode``: ``"perlayer"`` (static scales calibrated
    on ``frames``) or ``"e2e"`` (hybrid stem, calibrated on ``frames``).
    Returns the mean per-frame feature cosine and the feature relative
    RMS; with the fused test FC (``fused_kernel`` (1024, cols),
    ``fused_bias``) the fused scores' relative RMS, and with ``layout`` (a
    ``ReorganizedScoreLayout``) that of each head's columns:
    ``act_rel_rms`` / ``comp_rel_rms`` / ``reg_rel_rms``."""
    from ...ops.stpp import reorganized_score_slices
    from ...train.trainer import float32_convs_and_matmuls

    if mode not in ("perlayer", "e2e"):
        raise ValueError(f"unknown quantization_report mode {mode!r}")
    dev = frames.device
    float32_convs_and_matmuls()
    weights = {k: torch.as_tensor(v).to(dev) for k, v in state_dict.items()}
    with torch.no_grad():
        ref = torch.func.functional_call(backbone.eval(), weights, (frames,))
        if mode == "e2e":
            qe = tree_to(calibrate_e2e(state_dict, frames), dev)
            got = bninception_int8_e2e_features(qe, frames)
        else:
            q = tree_to(quantize_backbone(state_dict), dev)
            scales = calibrate_activation_scales(q, frames)
            got = bninception_int8_features(q, frames, act_scales=scales)
    ref = _host(ref).astype(np.float64)
    got = _host(got).astype(np.float64)
    cos = float(np.mean([
        np.dot(r, g) / (np.linalg.norm(r) * np.linalg.norm(g) + 1e-12)
        for r, g in zip(ref, got)]))
    rel = float(np.linalg.norm(got - ref) / (np.linalg.norm(ref) + 1e-12))
    report = {"feature_cosine": cos, "feature_rel_rms": rel}
    if fused_kernel is not None:
        kernel, bias = _host(fused_kernel), _host(fused_bias)
        sref = ref @ kernel + bias
        sgot = got @ kernel + bias

        def rel_rms(a, b):
            return float(np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-12))

        report["score_rel_rms"] = rel_rms(sgot, sref)
        if layout is not None:
            for name, sl in zip(("act", "comp", "reg"),
                                reorganized_score_slices(layout)):
                if sl is not None:
                    report[f"{name}_rel_rms"] = rel_rms(sgot[:, sl],
                                                        sref[:, sl])
    return report
