"""Dense actionness scorer: the device half of ``binary_test`` (torch port of
``action_detection_tpu/cli/binary_test.py:171-289,313-349``).

Every ``frame_interval``-th frame of a video is scored by the binary
actionness classifier on its 10 device crops. Unlike the SSN scorer it keeps
the score of every crop: features come crop-major as ``(crops * ticks,
D)``, go through ``classifier_fc``, and are reshaped to ``(ticks, crops,
K)``, the reference's per-crop pickle layout (``binary_test.py:84-94``) that
TAG grouping reads.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..data.binary_dataset import BinaryTestSample
from ..data.pipeline import iter_scaled_frame_chunks, pad_chunk_ticks
from ..models.backbones import InputSpec
from ..models.binary import BinaryClassifier
from .features import CropFeatureScorer


class ActionnessScorer(CropFeatureScorer):
    """Holds ``classifier_fc``, the (quantized) backbone and the decode pool
    (the feature step is :class:`~.features.CropFeatureScorer`'s)."""

    def __init__(self, model: BinaryClassifier, input_spec: InputSpec,
                 chunk_frames: int = 64, modality: str = "RGB",
                 device="cuda", quantize=False,
                 calibration_frames: Optional[np.ndarray] = None,
                 decode_threads: Optional[int] = None,
                 shared_stem: Optional[bool] = None):
        super().__init__(model, input_spec, test_crops=10,
                         chunk_frames=chunk_frames, modality=modality,
                         device=device, quantize=quantize,
                         calibration_frames=calibration_frames,
                         decode_threads=decode_threads,
                         shared_stem=shared_stem)
        self.num_class = model.num_class
        with torch.no_grad():
            fc = model.classifier_fc
            self._kernel = fc.weight.t().contiguous().float().to(self.device)
            self._bias = fc.bias.float().to(self.device)

    def _score_chunk(self, frames_u8: torch.Tensor) -> torch.Tensor:
        """``(ticks, H_scale, W_scale, C)`` uint8 frames on the device ->
        ``(ticks, crops, K)`` logits, one per crop."""
        feats = self._crop_features(frames_u8)
        with torch.no_grad():
            logits = torch.matmul(feats, self._kernel) + self._bias
            return logits.reshape(self.test_crops, frames_u8.shape[0],
                                  self.num_class).transpose(0, 1)

    def score_video(self, sample: BinaryTestSample, provider) -> np.ndarray:
        """``(T, crops, K)`` float32 logits of every tick of one video; a
        video with no ticks gives an empty ``(0, crops, K)`` array."""
        T = len(sample.frame_ticks)
        if T == 0:
            return np.zeros((0, self.test_crops, self.num_class), np.float32)
        chunks = iter_scaled_frame_chunks(
            provider, sample.video_id, sample.frame_ticks, sample.num_frames,
            self.input_spec.scale_size, new_length=self.new_length,
            batch_ticks=self.chunk_frames, executor=self._decode_pool)
        out = []
        for chunk in chunks:
            n_real = chunk.shape[0]
            chunk = pad_chunk_ticks(chunk, 1, self.chunk_frames)
            frames = torch.from_numpy(chunk).to(self.device)
            out.append(self._score_chunk(frames)[:n_real])
        scores = torch.cat(out, dim=0).cpu().numpy()
        if scores.shape[0] != T:
            raise RuntimeError(f"scored {scores.shape[0]} of {T} ticks of "
                               f"{sample.video_id}")
        return scores
