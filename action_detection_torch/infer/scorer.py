"""Proposal scorer: the dense-scoring inference path (torch port of
``action_detection_tpu/infer/scorer.py``).

* The CNN runs once per sampled frame; every proposal is scored by pooling
  the shared per-frame score matrix (linear-head commutation).
* With 10 device crops (the default) the host only decodes and rescales
  frames (in parallel); normalization, the oversample and the crop mean
  run on the device. With the shared stem (the int8-e2e default) the stem
  runs once per frame and its flip, and the 10 crop windows are cut from
  its output. ``test_crops=1`` (or ``device_crops=False``) cuts the crops
  on the host (``infer/features.py``). Frame chunks are padded to a
  fixed tick count, as in the JAX package.
* Proposal pooling is the cumsum-gather STPP on the device
  (``ops/stpp.py``), with part bounds from the host.
* ``score_video_pack`` (``--pack``) packs ticks of several videos into the
  same chunks: the padding is paid once per pack, not once per video, and
  the scores are equal to per-video scoring (every row of a chunk is
  scored on its own).
* ``score_videos`` fans videos out over devices: one thread and one scorer
  per device pulling from one queue, no collectives (the reference's
  process per GPU, without processes). The int8-e2e calibration of the
  first chunk is elected once and shared, so the scores do not depend on
  the device count. ``make_sharded_frame_scorer`` splits one video's frames
  over the devices instead.
* Chunks are built, sent and scored on the path both scorers share
  (``infer/features.py:CropFeatureScorer``: the staging ring, the chunk
  feed, the model step replayed as a CUDA graph); this scorer adds the
  crop mean and the fused FC, and pools and reads back each video under a
  ``pack.finish`` span.
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..data.ssn_dataset import SSNDataset, TestSample
from ..data.transforms import preprocess_frames
from ..models.backbones import InputSpec
from ..models.ssn import SSN, fuse_test_heads
from ..ops.stpp import (ReorganizedScoreLayout, StppConfig,
                        reorganized_stpp_pool)
from ..utils.meters import profiler, span_begin, span_end
from .features import CropFeatureScorer, fan_out, on_device

#: videos a ``--pack`` work item holds (bounds the host memory of a pack)
PACK_GROUP = 16


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
    (the feature step and the chunk path are
    :class:`~.features.CropFeatureScorer`'s)."""

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
                 prequantized=None, decode_pool=None):
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
                         shared_stem=shared_stem, prequantized=prequantized,
                         decode_pool=decode_pool)
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

    def _model_step(self, frames_u8: torch.Tensor,
                    n_stacks: int) -> torch.Tensor:
        """uint8 frames on the device (``(n_stacks, H_scale, W_scale, C)``,
        or ``test_crops * n_stacks`` host crops) -> ``(n_stacks, D)``
        crop-mean fused scores. Crops are mean-reduced on *features* before
        the fused FC — identical by linearity."""
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
        regression: the pack of one video, so its chunks are its own."""
        return self.score_video_pack([sample], provider,
                                     keep_raw=keep_raw)[0]

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

    def score_video_pack(self, samples, provider,
                         keep_raw: bool = False) -> List[ScoredVideo]:
        """Score several videos with their ticks packed across videos.

        ``score_video`` pads each video's ticks to a multiple of
        ``chunk_frames``; here ticks of consecutive videos share chunks, so
        a pack pays that padding once (per scale shape: videos whose
        scaled frames differ in shape pack in separate buffers, and each
        buffer's partial last chunk is padded;
        ``CropFeatureScorer._chunks``). Every row of a chunk is scored on
        its own, so the scores equal per-video scoring. The rows come back
        to per-video matrices on the device: one ``index_select`` over the
        chunks' scores and an appended zero row, with indices computed on
        the host; each matrix has a whole number of chunks' rows. The
        host-crop path's chunks hold one video each (they are crop-major).
        """
        pending = [(self._score_chunk(frames, self.chunk_frames), rows)
                   for frames, rows in self._chunks(samples, provider)]
        if not pending:
            return [self._empty_scored(s, keep_raw=keep_raw)
                    for s in samples]

        sp = profiler._is_profiler_enabled and span_begin("pack.finish")
        row_of = {key: ci * self.chunk_frames + r
                  for ci, (_, keys) in enumerate(pending)
                  for r, key in enumerate(keys)}
        with torch.no_grad():
            first = pending[0][0]
            all_scores = torch.cat([sc for sc, _ in pending]
                                   + [first.new_zeros(1, first.shape[1])])
        zero_row = all_scores.shape[0] - 1
        outs = []
        for si, s in enumerate(samples):
            T = len(s.frame_ticks)
            if T == 0:
                outs.append(self._empty_scored(s, keep_raw=keep_raw))
                continue
            idx = np.full(-(-T // self.chunk_frames) * self.chunk_frames,
                          zero_row, np.int64)
            idx[:T] = [row_of[si, row] for row in range(T)]
            with torch.no_grad():
                mat = all_scores.index_select(
                    0, torch.from_numpy(idx).to(self.device))
            outs.append(self._pool_video(s, mat, T, keep_raw=keep_raw))
        if sp:
            span_end(sp)
        return outs


def make_sharded_frame_scorer(model: SSN, kernel: torch.Tensor,
                              bias: torch.Tensor, input_spec: InputSpec,
                              devices: Sequence, modality: str = "RGB"):
    """One long video's frames split over ``devices``: each device scores
    its contiguous slice of the frames (one thread each, a copy of the
    float model and the fused test FC on each), and the score matrix is
    gathered on the first device. Returns ``frames_u8 (N, H, W, C) ->
    scores (N, D)`` (crop-shaped uint8 frames, numpy or a tensor)."""
    devices = [torch.device(d) for d in devices]
    replicas = [(copy.deepcopy(model).eval().to(d), kernel.to(d),
                 bias.to(d)) for d in devices]
    new_length = model.resolved_new_length

    def part(i: int, frames: torch.Tensor) -> torch.Tensor:
        net, k, b = replicas[i]
        with on_device(devices[i]), torch.no_grad():
            x = preprocess_frames(frames.to(devices[i]), input_spec,
                                  modality, new_length)
            return torch.matmul(net.features(x), k) + b

    def score(frames_u8) -> torch.Tensor:
        parts = torch.tensor_split(torch.as_tensor(frames_u8), len(devices))
        outs = _run_threads([lambda i=i, f=f: part(i, f)
                             for i, f in enumerate(parts)])
        return torch.cat([o.to(devices[0]) for o in outs])

    return score


def _run_threads(fns: Sequence[Callable]) -> list:
    """``fn()`` of each on a thread of its own; the results in order, or
    the first error raised."""
    results: list = [None] * len(fns)
    errors: list = []

    def run(i: int) -> None:
        try:
            results[i] = fns[i]()
        except BaseException as e:      # re-raised on the caller's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def score_videos(scorer_factory, dataset: SSNDataset, provider,
                 indices: Optional[Iterable[int]] = None,
                 devices: Optional[Sequence] = None, keep_raw: bool = False,
                 progress: bool = False,
                 pack: bool = False) -> Dict[str, ScoredVideo]:
    """Fan videos out over ``devices`` (default: every local GPU,
    ``parallel/mesh.py:select_devices``): independent work, no collectives
    (``features.py:fan_out``: one scorer and one thread a device, the
    lazy-calibration election). The work items are videos, or groups of
    ``PACK_GROUP`` with ``pack`` (``score_video_pack``; the group bounds
    the host memory of a pack). A device may appear twice: two scorers
    share it."""
    from ..parallel.mesh import select_devices

    indices = list(indices if indices is not None
                   else range(len(dataset.video_list)))
    items = ([indices[lo:lo + PACK_GROUP]
              for lo in range(0, len(indices), PACK_GROUP)] if pack
             else indices)
    results: Dict[str, ScoredVideo] = {}
    lock = threading.Lock()

    def score_item(scorer, item) -> None:
        if pack:
            outs = scorer.score_video_pack(
                [dataset.get_test_sample(i) for i in item], provider,
                keep_raw=keep_raw)
        else:
            outs = [scorer.score_video(dataset.get_test_sample(item),
                                       provider, keep_raw=keep_raw)]
        with lock:
            for out in outs:
                results[out.video_id] = out
                if progress:
                    print(f"scored {out.video_id} "
                          f"({len(results)}/{len(indices)})", flush=True)

    fan_out(scorer_factory,
            list(devices) if devices is not None else select_devices(),
            items, score_item)
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
