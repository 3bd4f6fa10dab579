"""Backbone-agnostic entry points for int8 quantized scoring (torch port of
``action_detection_tpu/models/backbones/quantize.py``).

Modes, as in the JAX package:

* ``e2e``      — int8 activations end to end (the default), BNInception and
                 InceptionV3;
* ``perlayer`` — bf16 activations quantized per tensor at each conv
                 (BNInception only; kept for comparison).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

_INT8_MODES = {
    "BNInception": ("e2e", "perlayer"),
    "InceptionV3": ("e2e",),
}


def supports_int8(arch: str, mode: str = "e2e") -> bool:
    return mode in _INT8_MODES.get(arch, ())


def int8_support_error(arch: str, mode: str = "e2e") -> str:
    return (f"int8 mode {mode!r} is not available for backbone {arch!r} "
            f"(supported: { {a: list(m) for a, m in _INT8_MODES.items()} })")


def calibrate_e2e_backbone(arch: str, state_dict, sample_frames: torch.Tensor
                           ) -> Dict[str, Any]:
    """Calibrate + build the e2e-quantized backbone from NORMALIZED frames."""
    if arch == "BNInception":
        from .bn_inception_int8 import calibrate_e2e

        return calibrate_e2e(state_dict, sample_frames)
    if arch == "InceptionV3":
        from .inception_v3_int8 import calibrate_e2e_iv3

        return calibrate_e2e_iv3(state_dict, sample_frames)
    raise ValueError(int8_support_error(arch))


def int8_e2e_features(arch: str, qe: Dict[str, Any],
                      x: torch.Tensor) -> torch.Tensor:
    """Normalized frames -> features through the arch's int8-e2e forward."""
    if arch == "BNInception":
        from .bn_inception_int8 import bninception_int8_e2e_features

        return bninception_int8_e2e_features(qe, x)
    if arch == "InceptionV3":
        from .inception_v3_int8 import inception_v3_int8_e2e_features

        return inception_v3_int8_e2e_features(qe, x)
    raise ValueError(int8_support_error(arch))


def supports_shared_stem(arch: str) -> bool:
    """Shared-stem 10-crop scoring is wired for both int8-e2e backbones."""
    return arch in ("BNInception", "InceptionV3")


def sharedstem_crop_windows(stem_fn, feature_hw, xn: torch.Tensor,
                            flip_src: torch.Tensor,
                            crop_size: int) -> torch.Tensor:
    """Run ``stem_fn`` once per frame (+ once per flipped frame) and slice
    the 10 oversample crop windows on the stride-8 trunk-input grid.

    * offsets snap to the stride-8 grid: ``snap(o) = int(o / 8 + 0.5)``,
      which rounds half UP (not ``torch.round``, which rounds half to even),
      clamped to the window range;
    * flipped crops slice a flipped-FRAME stem pass at the mirrored offset
      (``flip(crop(x, o)) == crop(flip(x), W - crop - o)``): stems are not
      flip-equivariant (BNInception's ceil-mode pools pad right/bottom only,
      InceptionV3's VALID stride-2 windows drop the right edge), so flipping
      stem outputs would be wrong;
    * Flow's plane inversion rides in ``flip_src``.

    Returns ``(10*N, fc, fc, C)`` NHWC trunk inputs, crop-major in exactly
    ``device_oversample_normed``'s [o0, o0-flip, o1, o1-flip, ...] order.
    """
    from ...data.transforms import fill_fix_offset

    N, H, W, _ = xn.shape
    fh, fw = feature_hw(H), feature_hw(W)
    fc = feature_hw(crop_size)

    def snap(o: int, lim: int) -> int:
        return min(max(int(o / 8 + 0.5), 0), lim)

    stem = stem_fn(torch.cat([xn, torch.flip(flip_src, dims=[2])], dim=0))
    sn, sf = stem[:N], stem[N:]
    windows = []
    for o_w, o_h in fill_fix_offset(False, W, H, crop_size, crop_size):
        fx, fy = snap(o_w, fw - fc), snap(o_h, fh - fc)
        windows.append(sn[:, fy:fy + fc, fx:fx + fc, :])
        mx = snap(W - crop_size - o_w, fw - fc)
        windows.append(sf[:, fy:fy + fc, mx:mx + fc, :])
    return torch.stack(windows, dim=0).reshape(
        (10 * N, fc, fc, stem.shape[-1]))


def int8_e2e_features_sharedstem(arch: str, qe: Dict[str, Any],
                                 xn: torch.Tensor, flip_src: torch.Tensor,
                                 crop_size: int) -> torch.Tensor:
    """Normalized FRAMES (+ flip source) -> (10*N, F) 10-crop features with
    the stem shared per frame instead of per crop."""
    if arch == "BNInception":
        from .bn_inception_int8 import (
            bninception_int8_e2e_features_sharedstem)

        return bninception_int8_e2e_features_sharedstem(qe, xn, flip_src,
                                                        crop_size)
    if arch == "InceptionV3":
        from .inception_v3_int8 import (
            inception_v3_int8_e2e_features_sharedstem)

        return inception_v3_int8_e2e_features_sharedstem(qe, xn, flip_src,
                                                         crop_size)
    raise ValueError(f"shared-stem is not available for backbone {arch!r}")
