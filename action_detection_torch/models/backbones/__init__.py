"""Backbone registry: torch feature extractors selectable by name.

Port of ``action_detection_tpu/models/backbones/__init__.py`` for the
backbones ported so far (BNInception, InceptionV3 and TinyConv).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .bn_inception import BNInception, FEATURE_DIM as BNINCEPTION_DIM

PORTED_ARCHS = ("BNInception", "InceptionV3", "TinyConv")


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """Per-backbone input pipeline facts (crop size, normalization, channel order)."""
    input_size: int
    mean: tuple
    std: tuple
    bgr: bool          # Caffe-ported nets take BGR channel order
    div255: bool       # torchvision-style nets take [0,1] inputs

    @property
    def scale_size(self) -> int:
        return self.input_size * 256 // 224


def get_backbone(name: str, modality: str = "RGB",
                 new_length: Optional[int] = None, bn_mode: str = "frozen",
                 remat: bool = False):
    """Build a backbone module + its feature dim + input spec.

    ``bn_mode`` and ``remat`` are the training options of
    :mod:`.common` (the JAX package's ``bn_mode``; ``--remat``)."""
    if new_length is None:
        new_length = 1 if modality == "RGB" else 5
    if modality in ("RGB", "RGBDiff"):
        in_channels = 3 * new_length
    elif modality == "Flow":
        in_channels = 2 * new_length
    else:
        raise ValueError(f"unknown modality {modality}")

    if name == "BNInception":
        if modality == "Flow":
            spec = InputSpec(224, (128.0,), (1.0,), bgr=False, div255=False)
        else:
            spec = InputSpec(224, (104.0, 117.0, 128.0), (1.0,), bgr=True,
                             div255=False)
        return (BNInception(in_channels, bn_mode, remat), BNINCEPTION_DIM,
                spec)
    if name == "InceptionV3":
        from .inception_v3 import InceptionV3, FEATURE_DIM as IV3_DIM

        if modality == "Flow":
            spec = InputSpec(299, (128.0,), (1.0,), bgr=False, div255=False)
        else:
            spec = InputSpec(299, (104.0, 117.0, 128.0), (1.0,), bgr=True,
                             div255=False)
        return InceptionV3(in_channels, bn_mode, remat), IV3_DIM, spec
    if name == "TinyConv":
        from .tiny import TinyConv, FEATURE_DIM as TINY_DIM

        spec = InputSpec(32, (104.0, 117.0, 128.0) if modality != "Flow"
                         else (128.0,), (1.0,), bgr=(modality != "Flow"),
                         div255=False)
        return TinyConv(in_channels, bn_mode, remat), TINY_DIM, spec
    raise ValueError(f"backbone {name!r} is not ported yet (ported: "
                     f"{', '.join(PORTED_ARCHS)}; ResNet and VGG come in "
                     f"later slices of the port)")
