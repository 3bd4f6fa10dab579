"""The feature step the two scorers share: uint8 scale-size frames on the
device -> per-crop backbone features of the 10-crop oversample.

:class:`CropFeatureScorer` holds the backbone (float, or int8 end to end
after calibration), the shared-stem choice and the host decode pool.
:class:`~.scorer.ProposalScorer` (SSN proposal scoring) means the features
over the crops before its fused FC; :class:`~.actionness.ActionnessScorer`
(dense actionness for TAG) keeps every crop's score. Constructing either
turns TF32 off for cuDNN and matmuls, for parity with the JAX package's
float32 convs and ``Precision.HIGHEST`` heads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.pipeline import make_decode_pool
from ..data.transforms import (device_normed_pair, device_oversample_normed,
                               preprocess_frames)
from ..models.backbones import InputSpec
from ..models.backbones.bn_inception_int8 import tree_to
from ..models.backbones.quantize import (calibrate_e2e_backbone,
                                         int8_e2e_features,
                                         int8_e2e_features_sharedstem,
                                         int8_support_error, supports_int8,
                                         supports_shared_stem)
from ..train.trainer import float32_convs_and_matmuls


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises (the
    port never continues on the CPU in place of a requested GPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but torch sees no CUDA "
                           "device")
    return dev


class CropFeatureScorer:
    """Backbone features of 10 device crops per frame, float or int8-e2e.

    ``model`` is an ``SSN`` or a ``BinaryClassifier`` (``arch``,
    ``base_model``, ``features``, ``resolved_new_length``). With
    ``quantize="e2e"`` the backbone calibrates on ``calibration_frames``
    (crop-shaped or scale-size uint8 frames), on a sibling scorer's
    ``export_quantized()`` (``prequantized``), or else on the first scored
    chunk.
    """

    def __init__(self, model, input_spec: InputSpec, test_crops: int = 10,
                 chunk_frames: int = 32, modality: str = "RGB",
                 device="cuda", quantize=False,
                 calibration_frames: Optional[np.ndarray] = None,
                 device_crops: Optional[bool] = None,
                 decode_threads: Optional[int] = None,
                 shared_stem: Optional[bool] = None,
                 prequantized=None):
        self.device = resolve_device(device)
        float32_convs_and_matmuls()

        self.model = model.eval()
        self.arch = model.arch
        self.input_spec = input_spec
        self.test_crops = test_crops
        self.chunk_frames = chunk_frames
        self.modality = modality
        self.new_length = model.resolved_new_length
        if device_crops is None:
            device_crops = test_crops == 10
        self.device_crops = device_crops and test_crops == 10
        if not self.device_crops:
            raise ValueError("the port scores with 10 device crops only; the "
                             "host-crop path (test_crops != 10) comes in a "
                             "later slice")
        self._decode_pool = make_decode_pool(decode_threads)

        can_share = supports_shared_stem(self.arch)
        self.shared_stem = bool(shared_stem) and can_share
        if shared_stem and not can_share:
            raise ValueError(
                "shared_stem requires device 10-crop oversampling and a "
                f"supported backbone (got {self.arch!r})")
        self._quantize_mode = ({False: None, None: None, True: "e2e"}
                               .get(quantize, quantize))
        if self._quantize_mode not in (None, "e2e"):
            raise ValueError(f"quantize mode {quantize!r} is not in the port "
                             "yet (only 'e2e')")
        if self.shared_stem and self._quantize_mode != "e2e":
            raise ValueError("shared_stem is only wired for the int8-e2e "
                             f"backbone (quantize={quantize!r})")
        if prequantized is not None and not self._quantize_mode:
            raise ValueError("prequantized requires quantize to be set")

        self._quantized = None
        self._qp = None
        if self._quantize_mode:
            if not supports_int8(self.arch, self._quantize_mode):
                raise ValueError(int8_support_error(self.arch,
                                                    self._quantize_mode))
            if prequantized is not None:
                # a sibling scorer's export_quantized(): calibration ran once
                self._quantized = tree_to(prequantized, self.device)
            else:
                # the float backbone only feeds calibration (host copy)
                self._qp = {k: v.detach().cpu() for k, v in
                            model.base_model.state_dict().items()}
                if calibration_frames is not None:
                    self._calibrate(torch.as_tensor(
                        np.asarray(calibration_frames), device=self.device))
        else:
            self.model.to(self.device)

    def export_quantized(self):
        """The quantized tree (CPU tensors) for a sibling scorer's
        ``prequantized=``, or None before calibration has run."""
        if self._quantized is None:
            return None
        return tree_to(self._quantized, "cpu")

    @property
    def needs_lazy_calibration(self) -> bool:
        """True while this scorer would calibrate on its next scored chunk."""
        return self._quantize_mode == "e2e" and self._quantized is None

    def close(self) -> None:
        """Shut down the decode thread pool (idempotent)."""
        if self._decode_pool is not None:
            self._decode_pool.shutdown(wait=False)
            self._decode_pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _calibrate(self, frames_u8: torch.Tensor) -> None:
        with torch.no_grad():
            sample = self._prep_calibration(frames_u8)
        self._quantized = tree_to(
            calibrate_e2e_backbone(self.arch, self._qp, sample), self.device)
        self._qp = None    # the host float copy only feeds calibration

    def _prep_calibration(self, frames: torch.Tensor) -> torch.Tensor:
        """Normalized CROP-shaped frames for quantization calibration.

        Scale-size inputs give the first crop offset's normal+flip groups;
        crop-shaped inputs pass through; an oversized dim of a smaller frame
        is center-cropped (see the JAX package's ``_prep_calibration``).
        """
        cs = self.input_spec.input_size
        H, W = frames.shape[1], frames.shape[2]
        if H >= cs and W >= cs and not (H == cs and W == cs):
            crops = device_oversample_normed(frames, self.input_spec,
                                             self.modality, self.new_length)
            return crops[: 2 * frames.shape[0]]
        if H > cs:
            o = (H - cs) // 2
            frames = frames[:, o:o + cs]
        if W > cs:
            o = (W - cs) // 2
            frames = frames[:, :, o:o + cs]
        return preprocess_frames(frames, self.input_spec, self.modality,
                                 self.new_length)

    def _crop_features(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """``(N, H_scale, W_scale, C)`` uint8 frames on the device ->
        ``(10 * N, D)`` features, crop-major ([o0, o0-flip, o1, ...] blocks
        of N), calibrating first where the int8 backbone still needs it."""
        if self.needs_lazy_calibration:
            self._calibrate(frames_u8)
        qe = self._quantized
        with torch.no_grad():
            if self.shared_stem:
                xn, flip_src = device_normed_pair(
                    frames_u8, self.input_spec, self.modality,
                    self.new_length)
                return int8_e2e_features_sharedstem(
                    self.arch, qe, xn, flip_src, self.input_spec.input_size)
            x = device_oversample_normed(frames_u8, self.input_spec,
                                         self.modality, self.new_length)
            if qe is not None:
                return int8_e2e_features(self.arch, qe, x)
            return self.model.features(x)
