"""SSN proposal dataset: pools, video-centric sampling, segment index math.

A host copy of ``action_detection_tpu/data/ssn_dataset.py`` with its imports
rewired to the port (the reference's ``data`` package reaches jax through
``ops/__init__``). The dataset produces frame indices and static-shape
metadata arrays; decoding is a separate frame-provider stage
(``data/pipeline.py``). All randomness flows through an explicit
``numpy.random.RandomState``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import SamplingConfig
from ..ops.iou import temporal_iou
from .proposal_io import load_proposal_file

FG, INCOMPLETE, BG = 0, 1, 2  # proposal type codes (reference convention)


class SSNInstance:
    """One temporal proposal (or GT instance) of a video."""

    def __init__(self, start_frame: int, end_frame: int, video_frame_count: int,
                 fps: float = 1, label: Optional[int] = None,
                 best_iou: Optional[float] = None,
                 overlap_self: Optional[float] = None):
        self.start_frame = start_frame
        self.end_frame = min(end_frame, video_frame_count)
        self._label = label
        self.fps = fps
        self.coverage = (end_frame - start_frame) / video_frame_count
        self.best_iou = best_iou
        self.overlap_self = overlap_self
        self.loc_reg: Optional[float] = None
        self.size_reg: Optional[float] = None

    def compute_regression_targets(self, gt_list: Sequence["SSNInstance"],
                                   fg_thresh: float) -> None:
        """(center shift / duration, log duration ratio) against the best GT."""
        if self.best_iou < fg_thresh:
            return
        ious = [temporal_iou((self.start_frame, self.end_frame),
                             (gt.start_frame, gt.end_frame)) for gt in gt_list]
        best_gt = gt_list[int(np.argmax(ious))]

        prop_center = (self.start_frame + self.end_frame) / 2
        gt_center = (best_gt.start_frame + best_gt.end_frame) / 2
        prop_size = self.end_frame - self.start_frame + 1
        gt_size = best_gt.end_frame - best_gt.start_frame + 1

        self.loc_reg = (gt_center - prop_center) / prop_size
        self.size_reg = math.log(gt_size / prop_size)

    @property
    def start_time(self) -> float:
        return self.start_frame / self.fps

    @property
    def end_time(self) -> float:
        return self.end_frame / self.fps

    @property
    def label(self) -> int:
        return self._label if self._label is not None else -1

    @property
    def regression_targets(self) -> Tuple[float, float]:
        return (self.loc_reg, self.size_reg) if self.loc_reg is not None else (0.0, 0.0)


class SSNVideoRecord:
    """A video's GT instances and candidate proposals from a proposal list."""

    def __init__(self, prop_record):
        self._data = prop_record
        frame_count = int(self._data[1])

        self.gt = [SSNInstance(int(x[1]), int(x[2]), frame_count, label=int(x[0]),
                               best_iou=1.0)
                   for x in self._data[2] if int(x[2]) > int(x[1])]
        self.gt = [x for x in self.gt if x.start_frame < frame_count]

        self.proposals = [SSNInstance(int(x[3]), int(x[4]), frame_count,
                                      label=int(x[0]), best_iou=float(x[1]),
                                      overlap_self=float(x[2]))
                          for x in self._data[3] if int(x[4]) > int(x[3])]
        self.proposals = [x for x in self.proposals if x.start_frame < frame_count]

    @property
    def id(self) -> str:
        return self._data[0]

    @property
    def num_frames(self) -> int:
        return int(self._data[1])

    def get_fg(self, fg_thresh: float, with_gt: bool = True) -> List[SSNInstance]:
        fg = [p for p in self.proposals if p.best_iou > fg_thresh]
        if with_gt:
            fg = fg + self.gt
        for x in fg:
            x.compute_regression_targets(self.gt, fg_thresh)
        return fg

    def get_negatives(self, incomplete_iou_thresh: float, bg_iou_thresh: float,
                      bg_coverage_thresh: float = 0.01,
                      incomplete_overlap_thresh: float = 0.7):
        incomplete, background = [], []
        for p in self.proposals:
            if (p.best_iou < incomplete_iou_thresh
                    and p.overlap_self > incomplete_overlap_thresh):
                incomplete.append(p)
            elif p.best_iou < bg_iou_thresh and p.coverage > bg_coverage_thresh:
                background.append(p)
        return incomplete, background


@dataclasses.dataclass
class TrainSample:
    """One video's sampled proposals: everything but the pixels."""
    video_id: str
    frame_indices: np.ndarray      # (P, S) int — 1-based frame numbers
    scaling: np.ndarray            # (P, 2) float32
    labels: np.ndarray             # (P,) int64
    reg_targets: np.ndarray        # (P, 2) float32 (normalized)
    prop_type: np.ndarray          # (P,) int64 in {FG, INCOMPLETE, BG}
    # cross-video fetches: frame indices belong to these video ids
    frame_video_ids: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class TestSample:
    """A video's dense scoring plan + proposal pooling geometry."""
    video_id: str
    frame_ticks: np.ndarray        # (T,) int — 1-based frame numbers to score
    num_frames: int                # real video frame count
    rel_props: np.ndarray          # (P, 2) float64 fraction coords
    prop_ticks: np.ndarray         # (P, 4) int in subsampled coordinates
    prop_scaling: np.ndarray       # (P, 2) float32


class SSNDataset:
    """Proposal pools + samplers over a parsed proposal list."""

    def __init__(self, prop_file: str,
                 sampling: Optional[SamplingConfig] = None,
                 body_seg: int = 5, aug_seg: int = 2,
                 new_length: int = 1,
                 video_centric: bool = True,
                 test_interval: int = 6,
                 gt_as_fg: bool = True,
                 reg_stats: Optional[np.ndarray] = None,
                 exclude_empty: bool = True,
                 epoch_multiplier: int = 1,
                 verbose: bool = False):
        self.prop_file = prop_file
        self.sampling = sampling or SamplingConfig()
        self.body_seg = body_seg
        self.aug_seg = aug_seg
        self.new_length = new_length
        self.video_centric = video_centric
        self.test_interval = test_interval
        self.gt_as_fg = gt_as_fg
        self.exclude_empty = exclude_empty
        self.epoch_multiplier = epoch_multiplier
        self.verbose = verbose

        self.starting_ratio = 0.5
        self.ending_ratio = 0.5

        self.fg_per_video = self.sampling.fg_per_video
        self.bg_per_video = self.sampling.bg_per_video
        self.incomplete_per_video = self.sampling.incomplete_per_video

        self._parse_prop_file(reg_stats)

    # ---------- parsing & pools ----------

    def _parse_prop_file(self, stats) -> None:
        prop_info = load_proposal_file(self.prop_file)
        self.video_list = [SSNVideoRecord(p) for p in prop_info]
        if self.exclude_empty:
            self.video_list = [v for v in self.video_list if len(v.gt) > 0]
        self.video_dict: Dict[str, SSNVideoRecord] = {v.id: v for v in self.video_list}

        s = self.sampling
        self.fg_pool, self.bg_pool, self.incomp_pool = [], [], []
        for v in self.video_list:
            self.fg_pool.extend((v.id, p) for p in v.get_fg(s.fg_iou_thresh, self.gt_as_fg))
            incomp, bg = v.get_negatives(s.incomplete_iou_thresh, s.bg_iou_thresh,
                                         s.bg_coverage_thresh,
                                         s.incomplete_overlap_thresh)
            self.incomp_pool.extend((v.id, p) for p in incomp)
            self.bg_pool.extend((v.id, p) for p in bg)

        if stats is None:
            self._compute_regression_stats()
        else:
            self.stats = np.asarray(stats)

        if self.verbose:
            print(f"SSNDataset: {self.prop_file} parsed. "
                  f"{len(self.video_list)} videos, "
                  f"fg/incomp/bg pools: {len(self.fg_pool)}/"
                  f"{len(self.incomp_pool)}/{len(self.bg_pool)}; "
                  f"reg stats loc {self.stats[0][0]:.5f}±{self.stats[1][0]:.5f} "
                  f"dur {self.stats[0][1]:.5f}±{self.stats[1][1]:.5f}")

    def _compute_regression_stats(self) -> None:
        targets = []
        for video in self.video_list:
            for p in video.get_fg(self.sampling.fg_iou_thresh, False):
                targets.append(list(p.regression_targets))
        if targets:
            self.stats = np.array((np.mean(targets, axis=0), np.std(targets, axis=0)))
        else:
            self.stats = np.array([[0.0, 0.0], [1.0, 1.0]])

    # ---------- segment index sampling ----------

    @staticmethod
    def _sample_indices(valid_length: int, num_seg: int,
                        rng: np.random.RandomState) -> np.ndarray:
        """Jittered uniform segment offsets (TSN-style sparse sampling)."""
        average_duration = (valid_length + 1) // num_seg
        if average_duration > 0:
            return (np.multiply(list(range(num_seg)), average_duration)
                    + rng.randint(average_duration, size=num_seg))
        if valid_length > num_seg:
            return np.sort(rng.randint(valid_length, size=num_seg))
        return np.zeros((num_seg,), dtype=np.int64)

    @staticmethod
    def _get_val_indices(valid_length: int, num_seg: int) -> np.ndarray:
        if valid_length > num_seg:
            tick = valid_length / float(num_seg)
            return np.array([int(tick / 2.0 + tick * x) for x in range(num_seg)])
        return np.zeros((num_seg,), dtype=np.int64)

    def sample_ssn_indices(self, prop: SSNInstance, frame_cnt: int,
                           rng: Optional[np.random.RandomState] = None):
        """9 segment frame numbers over the augmented proposal span + validity
        scalings (ssn_dataset.py:318-345 semantics, including every integer
        truncation)."""
        start_frame = prop.start_frame + 1
        end_frame = prop.end_frame
        duration = end_frame - start_frame + 1
        assert duration != 0, (prop.start_frame, prop.end_frame, prop.best_iou)
        valid_length = duration - self.new_length

        valid_starting = max(1, start_frame - int(duration * self.starting_ratio))
        valid_ending = min(frame_cnt - self.new_length + 1,
                           end_frame + int(duration * self.ending_ratio))

        valid_starting_length = start_frame - valid_starting - self.new_length + 1
        valid_ending_length = valid_ending - end_frame - self.new_length + 1

        starting_scale = ((valid_starting_length + self.new_length - 1)
                          / (duration * self.starting_ratio))
        ending_scale = ((valid_ending_length + self.new_length - 1)
                        / (duration * self.ending_ratio))

        random_shift = rng is not None
        starting = (self._sample_indices(valid_starting_length, self.aug_seg, rng)
                    if random_shift else
                    self._get_val_indices(valid_starting_length, self.aug_seg)) + valid_starting
        course = (self._sample_indices(valid_length, self.body_seg, rng)
                  if random_shift else
                  self._get_val_indices(valid_length, self.body_seg)) + start_frame
        ending = (self._sample_indices(valid_ending_length, self.aug_seg, rng)
                  if random_shift else
                  self._get_val_indices(valid_ending_length, self.aug_seg)) + end_frame

        offsets = np.concatenate((starting, course, ending)).astype(np.int64)
        stage_split = (self.aug_seg, self.aug_seg + self.body_seg,
                       2 * self.aug_seg + self.body_seg)
        return offsets, float(starting_scale), float(ending_scale), stage_split

    # ---------- training sampling ----------

    def _video_centric_sampling(self, video: SSNVideoRecord,
                                rng: np.random.RandomState):
        s = self.sampling
        fg = video.get_fg(s.fg_iou_thresh, self.gt_as_fg)
        incomp, bg = video.get_negatives(s.incomplete_iou_thresh, s.bg_iou_thresh,
                                         s.bg_coverage_thresh,
                                         s.incomplete_overlap_thresh)

        def sample(ptype, video_pool, requested, dataset_pool):
            if len(video_pool) == 0:
                if len(dataset_pool) == 0:
                    raise ValueError(
                        f"proposal pool for type {ptype} is empty dataset-wide; "
                        "check the proposal list against the sampling thresholds")
                idx = rng.choice(len(dataset_pool), requested, replace=False)
                return [(dataset_pool[i], ptype) for i in idx]
            replicate = len(video_pool) < requested
            idx = rng.choice(len(video_pool), requested, replace=replicate)
            return [((video.id, video_pool[i]), ptype) for i in idx]

        out = []
        out.extend(sample(FG, fg, self.fg_per_video, self.fg_pool))
        out.extend(sample(INCOMPLETE, incomp, self.incomplete_per_video, self.incomp_pool))
        out.extend(sample(BG, bg, self.bg_per_video, self.bg_pool))
        return out

    def _random_sampling(self, rng: np.random.RandomState):
        out = []
        for pool, ptype, num in ((self.fg_pool, FG, self.fg_per_video),
                                 (self.incomp_pool, INCOMPLETE, self.incomplete_per_video),
                                 (self.bg_pool, BG, self.bg_per_video)):
            idx = rng.choice(len(pool), num, replace=False)
            out.extend((pool[i], ptype) for i in idx)
        return out

    def get_training_sample(self, index: int,
                            rng: np.random.RandomState,
                            random_shift: bool = True) -> TrainSample:
        """Sample one video's proposal set -> indices/labels/targets arrays."""
        real_index = index % len(self.video_list)
        video = self.video_list[real_index]
        props = (self._video_centric_sampling(video, rng) if self.video_centric
                 else self._random_sampling(rng))

        P = len(props)
        S = self.body_seg + 2 * self.aug_seg
        frame_indices = np.zeros((P, S), dtype=np.int64)
        scaling = np.zeros((P, 2), dtype=np.float32)
        labels = np.zeros((P,), dtype=np.int64)
        reg_targets = np.zeros((P, 2), dtype=np.float32)
        prop_type = np.zeros((P,), dtype=np.int64)
        frame_video_ids = []

        for i, ((vid, prop), ptype) in enumerate(props):
            frame_cnt = self.video_dict[vid].num_frames
            offsets, s_scale, e_scale, _ = self.sample_ssn_indices(
                prop, frame_cnt, rng if random_shift else None)
            # clamp like the reference's min(frame_cnt, p + x) image fetch
            frame_indices[i] = np.minimum(offsets, frame_cnt)
            scaling[i] = (s_scale, e_scale)
            prop_type[i] = ptype
            labels[i] = 0 if ptype == BG else prop.label
            if ptype == FG:
                loc, dur = prop.regression_targets
                reg_targets[i] = ((loc - self.stats[0][0]) / self.stats[1][0],
                                  (dur - self.stats[0][1]) / self.stats[1][1])
            frame_video_ids.append(vid)

        return TrainSample(video_id=video.id, frame_indices=frame_indices,
                           scaling=scaling, labels=labels,
                           reg_targets=reg_targets, prop_type=prop_type,
                           frame_video_ids=frame_video_ids)

    # ---------- test planning ----------

    def get_test_sample(self, index: int) -> TestSample:
        """Dense scoring plan: frame ticks + per-proposal pooling geometry
        (ssn_dataset.py:393-453 semantics)."""
        video = self.video_list[index % len(self.video_list)]
        frame_cnt = video.num_frames
        frame_ticks = np.arange(0, frame_cnt - self.new_length,
                                self.test_interval, dtype=np.int64) + 1
        num_sampled = len(frame_ticks)

        props = list(video.proposals)
        if len(props) == 0:
            props.append(SSNInstance(0, frame_cnt - 1, frame_cnt))

        rel_props, prop_ticks, scalings = [], [], []
        for proposal in props:
            rel = (proposal.start_frame / frame_cnt, proposal.end_frame / frame_cnt)
            rel_duration = rel[1] - rel[0]
            rel_start_dur = rel_duration * self.starting_ratio
            rel_end_dur = rel_duration * self.ending_ratio
            real_rel_starting = max(0.0, rel[0] - rel_start_dur)
            real_rel_ending = min(1.0, rel[1] + rel_end_dur)

            scalings.append(((rel[0] - real_rel_starting) / rel_start_dur,
                             (real_rel_ending - rel[1]) / rel_end_dur))
            prop_ticks.append((int(real_rel_starting * num_sampled),
                               int(rel[0] * num_sampled),
                               int(rel[1] * num_sampled),
                               int(real_rel_ending * num_sampled)))
            rel_props.append(rel)

        return TestSample(video_id=video.id, frame_ticks=frame_ticks,
                          num_frames=frame_cnt,
                          rel_props=np.asarray(rel_props, dtype=np.float64),
                          prop_ticks=np.asarray(prop_ticks, dtype=np.int64),
                          prop_scaling=np.asarray(scalings, dtype=np.float32))

    def get_all_gt(self) -> List[List]:
        """[(vid, label-1, rel_start, rel_end)] over all videos (eval GT)."""
        gt_list = []
        for video in self.video_list:
            gt_list.extend([[video.id, x.label - 1,
                             x.start_frame / video.num_frames,
                             x.end_frame / video.num_frames] for x in video.gt])
        return gt_list

    def __len__(self) -> int:
        return len(self.video_list) * self.epoch_multiplier
