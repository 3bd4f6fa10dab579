"""Binary actionness dataset (fg/bg pools) for TAG training and dense scoring.

A host copy of ``action_detection_tpu/data/binary_dataset.py`` (parity
target of both: the reference's ``load_binary_score.py``): an
index-producing sampler with an explicit RNG, frame decode deferred to the
pipeline. The training sampler is here for the training CLI.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from .proposal_io import load_proposal_file
from .ssn_dataset import SSNDataset, SSNInstance

BG_TYPE, FG_TYPE = 0, 1  # binary labels: positions in batch are [fg... | bg...]


class BinaryVideoRecord:
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

    def get_fg(self, fg_thresh: float, with_gt: bool = True):
        fg = [p for p in self.proposals if p.best_iou > fg_thresh]
        return fg + self.gt if with_gt else fg

    def get_bg(self, bg_thresh: float):
        return [p for p in self.proposals if p.best_iou < bg_thresh]


@dataclasses.dataclass
class BinaryTrainSample:
    video_id: str
    frame_indices: np.ndarray   # (P, S) int — course segments only
    labels: np.ndarray          # (P,) int64: 1 fg, 0 bg
    frame_video_ids: List[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BinaryTestSample:
    video_id: str
    frame_ticks: np.ndarray     # (T,) int — every test_interval frames
    num_frames: int


class BinaryDataset:
    """fg/bg proposal pools with 3:9 per-video sampling (binary_model recipe)."""

    def __init__(self, prop_file: str,
                 body_seg: int = 5,
                 new_length: int = 1,
                 prop_per_video: int = 12, fg_ratio: int = 3, bg_ratio: int = 9,
                 fg_iou_thresh: float = 0.7, bg_iou_thresh: float = 0.01,
                 bg_coverage_thresh: float = 0.02,
                 gt_as_fg: bool = True, test_interval: int = 6,
                 exclude_empty: bool = True, epoch_multiplier: int = 1,
                 verbose: bool = False):
        self.prop_file = prop_file
        self.body_seg = body_seg
        self.new_length = new_length
        self.test_interval = test_interval
        self.fg_iou_thresh = fg_iou_thresh
        self.bg_iou_thresh = bg_iou_thresh
        self.bg_coverage_thresh = bg_coverage_thresh
        self.gt_as_fg = gt_as_fg
        self.exclude_empty = exclude_empty
        self.epoch_multiplier = epoch_multiplier
        self.verbose = verbose
        self.starting_ratio = 0.5
        self.ending_ratio = 0.5

        denum = fg_ratio + bg_ratio
        self.fg_per_video = int(prop_per_video * (fg_ratio / denum))
        self.bg_per_video = int(prop_per_video * (bg_ratio / denum))

        self._parse_prop_file()

    def _parse_prop_file(self) -> None:
        prop_info = load_proposal_file(self.prop_file)
        self.video_list = [BinaryVideoRecord(p) for p in prop_info]
        if self.exclude_empty:
            self.video_list = [v for v in self.video_list if len(v.gt) > 0]
        self.video_dict: Dict[str, BinaryVideoRecord] = {v.id: v for v in self.video_list}

        self.fg_pool, self.bg_pool = [], []
        for v in self.video_list:
            self.fg_pool.extend((v.id, p) for p in v.get_fg(self.fg_iou_thresh,
                                                            self.gt_as_fg))
            self.bg_pool.extend((v.id, p) for p in v.get_bg(self.bg_iou_thresh))
        if self.verbose:
            print(f"BinaryDataset: {self.prop_file}: {len(self.video_list)} videos, "
                  f"fg/bg pools {len(self.fg_pool)}/{len(self.bg_pool)}")

    def _sample_course_indices(self, prop: SSNInstance, frame_cnt: int,
                               rng: Optional[np.random.RandomState]) -> np.ndarray:
        """Course-stage segment sampling: one frame per rounded proposal stage
        (load_binary_score.py:178-195 semantics)."""
        start_frame = prop.start_frame + 1
        end_frame = prop.end_frame
        duration = end_frame - start_frame + 1
        sample_duration = duration / self.body_seg

        if rng is None:
            # deterministic validation path: stage centers
            offsets = SSNDataset._get_val_indices(duration - self.new_length,
                                                  self.body_seg)
            return np.minimum(offsets + start_frame, frame_cnt).astype(np.int64)

        if sample_duration < 1:
            idx = start_frame + rng.randint(
                max(prop.end_frame - prop.start_frame, 1), size=self.body_seg)
            return np.minimum(idx, frame_cnt).astype(np.int64)

        split_stage = [int(np.round(i * sample_duration)) + start_frame
                       for i in range(self.body_seg + 1)]
        idx = [rng.choice(range(split_stage[i], max(split_stage[i + 1],
                                                    split_stage[i] + 1)))
               for i in range(self.body_seg)]
        return np.minimum(np.asarray(idx, dtype=np.int64), frame_cnt)

    def get_training_sample(self, index: int, rng: np.random.RandomState,
                            random_shift: bool = True) -> BinaryTrainSample:
        video = self.video_list[index % len(self.video_list)]
        fg = video.get_fg(self.fg_iou_thresh, self.gt_as_fg)
        bg = video.get_bg(self.bg_iou_thresh)

        def sample(video_pool, requested, dataset_pool):
            if len(video_pool) == 0:
                idx = rng.choice(len(dataset_pool), requested, replace=False)
                return [dataset_pool[i] for i in idx]
            replicate = len(video_pool) < requested
            idx = rng.choice(len(video_pool), requested, replace=replicate)
            return [(video.id, video_pool[i]) for i in idx]

        props = ([(p, FG_TYPE) for p in sample(fg, self.fg_per_video, self.fg_pool)]
                 + [(p, BG_TYPE) for p in sample(bg, self.bg_per_video, self.bg_pool)])

        P = len(props)
        frame_indices = np.zeros((P, self.body_seg), dtype=np.int64)
        labels = np.zeros((P,), dtype=np.int64)
        frame_video_ids = []
        for i, ((vid, prop), ptype) in enumerate(props):
            frame_cnt = self.video_dict[vid].num_frames
            frame_indices[i] = self._sample_course_indices(
                prop, frame_cnt, rng if random_shift else None)
            labels[i] = ptype
            frame_video_ids.append(vid)
        return BinaryTrainSample(video_id=video.id, frame_indices=frame_indices,
                                 labels=labels, frame_video_ids=frame_video_ids)

    def get_test_sample(self, index: int) -> BinaryTestSample:
        video = self.video_list[index % len(self.video_list)]
        frame_cnt = video.num_frames
        frame_ticks = np.arange(0, frame_cnt - self.new_length,
                                self.test_interval, dtype=np.int64) + 1
        return BinaryTestSample(video_id=video.id, frame_ticks=frame_ticks,
                                num_frames=frame_cnt)

    def __len__(self) -> int:
        return len(self.video_list) * self.epoch_multiplier
