"""Dense actionness scorer: the device half of ``binary_test`` (torch port of
``action_detection_tpu/cli/binary_test.py:171-289,313-349``).

Every ``frame_interval``-th frame of a video is scored by the binary
actionness classifier on its crops: 10 cut on the device (the default), or
cut on the host (``--host_crops``, ``--test_crops 1``). Unlike the SSN
scorer it keeps the score of every crop: features come crop-major as
``(crops * ticks, D)``, go through ``classifier_fc``, and are reshaped to
``(ticks, crops, K)``, the reference's per-crop pickle layout
(``binary_test.py:84-94``) that TAG grouping reads. :func:`score_actionness`
scores a list of videos over several devices: one thread and one scorer
per device pulling videos from one queue (the JAX CLI's ``:300-400``).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from ..data.binary_dataset import BinaryTestSample
from ..models.backbones import InputSpec
from ..models.binary import BinaryClassifier
from .features import CropFeatureScorer, fan_out


class ActionnessScorer(CropFeatureScorer):
    """Holds ``classifier_fc``, the (quantized) backbone and the decode pool
    (the feature step and the chunk path are
    :class:`~.features.CropFeatureScorer`'s)."""

    def __init__(self, model: BinaryClassifier, input_spec: InputSpec,
                 test_crops: int = 10, chunk_frames: int = 64,
                 modality: str = "RGB", device="cuda", quantize=False,
                 calibration_frames: Optional[np.ndarray] = None,
                 device_crops: Optional[bool] = None,
                 decode_threads: Optional[int] = None,
                 shared_stem: Optional[bool] = None, prequantized=None,
                 decode_pool=None):
        super().__init__(model, input_spec, test_crops=test_crops,
                         chunk_frames=chunk_frames, modality=modality,
                         device=device, quantize=quantize,
                         calibration_frames=calibration_frames,
                         device_crops=device_crops,
                         decode_threads=decode_threads,
                         shared_stem=shared_stem, prequantized=prequantized,
                         decode_pool=decode_pool)
        self.num_class = model.num_class
        with torch.no_grad():
            fc = model.classifier_fc
            self._kernel = fc.weight.t().contiguous().float().to(self.device)
            self._bias = fc.bias.float().to(self.device)

    def _model_step(self, frames_u8: torch.Tensor,
                    n_stacks: int) -> torch.Tensor:
        """uint8 frames on the device (``(n_stacks, H_scale, W_scale, C)``,
        or ``crops * n_stacks`` host crops) -> ``(n_stacks, crops, K)``
        logits, one per crop."""
        feats = self._crop_features(frames_u8)
        with torch.no_grad():
            logits = torch.matmul(feats, self._kernel) + self._bias
            return logits.reshape(self.test_crops, n_stacks,
                                  self.num_class).transpose(0, 1)

    def score_video(self, sample: BinaryTestSample, provider) -> np.ndarray:
        """``(T, crops, K)`` float32 logits of every tick of one video; a
        video with no ticks gives an empty ``(0, crops, K)`` array."""
        scores = np.zeros((len(sample.frame_ticks), self.test_crops,
                           self.num_class), np.float32)
        parts, rows = [], []
        for frames, keys in self._chunks([sample], provider):
            parts.append(self._score_chunk(frames, self.chunk_frames)
                         [:len(keys)])
            rows += [row for _, row in keys]
        if parts:
            scores[rows] = torch.cat(parts).cpu().numpy()
        return scores


def score_actionness(scorer_factory, dataset, provider,
                     indices: Optional[Iterable[int]] = None,
                     devices: Optional[Sequence] = None,
                     progress: bool = False) -> Dict[str, np.ndarray]:
    """``{video basename: (T, crops, K) logits}`` of ``dataset``'s videos
    over ``devices`` (default: every local GPU): one scorer and one thread
    a device pulling video indices from one queue (``features.py:
    fan_out``). Keys are the video ids' basenames: proposal lists carry
    frame-folder paths, TAG grouping matches dataset-DB ids."""
    from ..parallel.mesh import select_devices

    results: Dict[str, np.ndarray] = {}
    lock = threading.Lock()
    t0 = time.time()

    def score_item(scorer, idx) -> None:
        sample = dataset.get_test_sample(idx)
        scores = scorer.score_video(sample, provider)
        with lock:
            results[sample.video_id.split("/")[-1]] = scores
            done = len(results)
        if progress:
            print(f"video {idx} {sample.video_id} done "
                  f"({(time.time() - t0) / done:.3f} sec/video)", flush=True)

    fan_out(scorer_factory,
            list(devices) if devices is not None else select_devices(),
            indices if indices is not None
            else range(len(dataset.video_list)), score_item)
    return results
