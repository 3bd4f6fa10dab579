"""Proposal scorer: the dense-scoring inference path (torch port of
``action_detection_tpu/infer/scorer.py``).

* The CNN runs once per sampled frame; every proposal is scored by pooling
  the shared per-frame score matrix (linear-head commutation).
* The host only decodes and rescales frames (in parallel); normalization,
  the 10-crop oversample and the crop mean run on the device. With the
  shared stem (the int8-e2e default) the stem runs once per frame and its
  flip, and the 10 crop windows are cut from its output.
* Frame chunks are padded to a fixed tick count, as in the JAX package.
* Proposal pooling is the cumsum-gather STPP on the device
  (``ops/stpp.py``), with part bounds from the host.

This slice scores on one device, with 10 device crops. Cross-video packing
(``--pack``), the host-crop path (``test_crops=1``) and the multi-device
fan-out come in later slices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..data.pipeline import iter_scaled_frame_chunks, pad_chunk_ticks
from ..data.ssn_dataset import SSNDataset, TestSample
from ..models.backbones import InputSpec
from ..models.ssn import SSN, fuse_test_heads
from ..ops.stpp import (ReorganizedScoreLayout, StppConfig,
                        reorganized_stpp_pool)
from .features import CropFeatureScorer


@dataclasses.dataclass
class ScoredVideo:
    """Per-video inference result (the reference's result-queue tuple)."""
    video_id: str
    rel_props: np.ndarray     # (P, 2)
    act_scores: np.ndarray    # (P, K+1)
    comp_scores: np.ndarray   # (P, K)
    reg_scores: Optional[np.ndarray]   # (P, K, 2) denormalized
    raw_scores: Optional[np.ndarray] = None   # (T, D_out) fused frame scores

    def as_tuple(self):
        return (self.rel_props, self.act_scores, self.comp_scores,
                self.reg_scores)


class ProposalScorer(CropFeatureScorer):
    """Holds the fused test FC, the (quantized) backbone and the decode pool
    (the feature step is :class:`~.features.CropFeatureScorer`'s)."""

    def __init__(self, model: SSN, input_spec: InputSpec,
                 reg_stats: Optional[np.ndarray] = None,
                 num_class: Optional[int] = None,
                 stpp_cfg=(1, 1, 1), test_crops: int = 10,
                 chunk_frames: int = 32,
                 modality: str = "RGB",
                 device="cuda",
                 with_regression: bool = True,
                 quantize=False,
                 calibration_frames: Optional[np.ndarray] = None,
                 device_crops: Optional[bool] = None,
                 decode_threads: Optional[int] = None,
                 shared_stem: Optional[bool] = None,
                 prequantized=None):
        self.reg_stats = (np.asarray(reg_stats) if reg_stats is not None
                          else None)
        if with_regression and self.reg_stats is None:
            # silently emitting NORMALIZED regression scores would shift
            # every detection boundary downstream
            raise ValueError(
                "with_regression=True requires reg_stats (the checkpoint's "
                "regression-target normalization); pass with_regression=False "
                "to score without boundary regression")
        super().__init__(model, input_spec, test_crops=test_crops,
                         chunk_frames=chunk_frames, modality=modality,
                         device=device, quantize=quantize,
                         calibration_frames=calibration_frames,
                         device_crops=device_crops,
                         decode_threads=decode_threads,
                         shared_stem=shared_stem, prequantized=prequantized)
        self.num_class = num_class or model.num_class
        self.with_regression = with_regression

        kernel, bias = fuse_test_heads(model, self.num_class, stpp_cfg,
                                       with_regression=with_regression)
        self._kernel = kernel.to(self.device)
        self._bias = bias.to(self.device)
        self._reg_stats_dev = (torch.as_tensor(self.reg_stats,
                                               dtype=torch.float32,
                                               device=self.device)
                               if self.reg_stats is not None else None)
        self.stpp = StppConfig.from_raw(stpp_cfg)
        K = self.num_class
        self.layout = ReorganizedScoreLayout(
            act_len=K + 1, comp_len=K, reg_len=2 * K,
            feat_multiplier=self.stpp.feat_multiplier,
            with_regression=with_regression)

    def _score_chunk(self, frames_u8: torch.Tensor,
                     n_stacks: int) -> torch.Tensor:
        """``(n_stacks, H_scale, W_scale, C)`` uint8 frames on the device ->
        ``(n_stacks, D)`` crop-mean fused scores.

        Crops are mean-reduced on *features* before the fused FC — identical
        by linearity.
        """
        feats = self._crop_features(frames_u8)
        with torch.no_grad():
            feats = feats.reshape(self.test_crops, n_stacks, -1).mean(dim=0)
            return torch.matmul(feats, self._kernel) + self._bias

    # --- host orchestration ---

    def _empty_scored(self, sample: TestSample,
                      keep_raw: bool = False) -> ScoredVideo:
        """Zero-score result for a video with no frame ticks."""
        P = sample.prop_ticks.shape[0]
        K = self.num_class
        D = self.layout.total_cols
        return ScoredVideo(
            video_id=sample.video_id, rel_props=sample.rel_props,
            act_scores=np.zeros((P, K + 1), np.float32),
            comp_scores=np.zeros((P, K), np.float32),
            reg_scores=(np.zeros((P, K, 2), np.float32)
                        if self.with_regression else None),
            raw_scores=np.zeros((0, D), np.float32) if keep_raw else None)

    def score_video(self, sample: TestSample, provider,
                    keep_raw: bool = False) -> ScoredVideo:
        """Score every sampled frame, pool per proposal, denormalize
        regression."""
        if len(sample.frame_ticks) == 0:
            return self._empty_scored(sample, keep_raw=keep_raw)
        chunks = iter_scaled_frame_chunks(
            provider, sample.video_id, sample.frame_ticks, sample.num_frames,
            self.input_spec.scale_size, new_length=self.new_length,
            batch_ticks=self.chunk_frames, executor=self._decode_pool)
        T = len(sample.frame_ticks)
        out_chunks = []
        filled = 0
        for chunk in chunks:
            n_real = chunk.shape[0]
            chunk = pad_chunk_ticks(chunk, 1, self.chunk_frames)
            frames = torch.from_numpy(chunk).to(self.device)
            out_chunks.append(self._score_chunk(frames, self.chunk_frames))
            filled += n_real
        if filled != T:
            raise RuntimeError(f"scored {filled} of {T} ticks of "
                               f"{sample.video_id}")
        return self._pool_video(sample, torch.cat(out_chunks, dim=0), T,
                                keep_raw=keep_raw)

    def _pool_video(self, sample: TestSample, frame_scores: torch.Tensor,
                    T: int, keep_raw: bool = False) -> ScoredVideo:
        """Pool one video's (T_padded, D) frame-score matrix into proposal
        scores."""
        with torch.no_grad():
            act, comp, reg = reorganized_stpp_pool(
                frame_scores, sample.prop_ticks, sample.prop_scaling,
                self.layout, self.stpp, num_frames=T)
            if reg is not None and self._reg_stats_dev is not None:
                stats = self._reg_stats_dev
                reg = reg.reshape(-1, self.num_class, 2) * stats[1] + stats[0]
        return ScoredVideo(
            video_id=sample.video_id, rel_props=sample.rel_props,
            act_scores=act.cpu().numpy(), comp_scores=comp.cpu().numpy(),
            reg_scores=reg.cpu().numpy() if reg is not None else None,
            raw_scores=(frame_scores[:T].cpu().numpy() if keep_raw
                        else None))


def score_videos(scorer_factory, dataset: SSNDataset, provider,
                 indices: Optional[Iterable[int]] = None, device="cuda",
                 keep_raw: bool = False,
                 progress: bool = False) -> Dict[str, ScoredVideo]:
    """Score videos on one device with ``scorer_factory(device)``."""
    indices = list(indices if indices is not None
                   else range(len(dataset.video_list)))
    results: Dict[str, ScoredVideo] = {}
    scorer = scorer_factory(device)
    try:
        for i in indices:
            out = scorer.score_video(dataset.get_test_sample(i), provider,
                                     keep_raw=keep_raw)
            results[out.video_id] = out
            if progress:
                print(f"scored {out.video_id} "
                      f"({len(results)}/{len(indices)})", flush=True)
    finally:
        scorer.close()
    return results


def dump_scores_pickle(results: Dict[str, ScoredVideo], path: str,
                       raw_path: Optional[str] = None) -> None:
    """Reference-compatible pickle: {vid: (rel_props, act, comp, reg)}."""
    import pickle

    out = {vid: r.as_tuple() for vid, r in results.items()}
    with open(path, "wb") as f:
        pickle.dump(out, f, pickle.HIGHEST_PROTOCOL)
    if raw_path:
        raw = {vid: r.raw_scores for vid, r in results.items()}
        with open(raw_path, "wb") as f:
            pickle.dump(raw, f, pickle.HIGHEST_PROTOCOL)
