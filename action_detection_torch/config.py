"""Dataset-level configuration as Python constants.

The values of ``action_detection_tpu/configs/dataset_cfg.yaml`` for the two
detection datasets, held as typed dataclasses so the port needs no yaml
parser (the machines it runs on have none).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

StageCfg = Union[int, Tuple[int, ...]]


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    """Proposal pool thresholds and per-video sampling ratios."""
    fg_iou_thresh: float = 0.7
    bg_iou_thresh: float = 0.01
    incomplete_iou_thresh: float = 0.3
    bg_coverage_thresh: float = 0.02
    incomplete_overlap_thresh: float = 0.7
    prop_per_video: int = 8
    fg_ratio: int = 1
    bg_ratio: int = 1
    incomplete_ratio: int = 6

    @property
    def fg_per_video(self) -> int:
        denum = self.fg_ratio + self.bg_ratio + self.incomplete_ratio
        return int(self.prop_per_video * (self.fg_ratio / denum))

    @property
    def bg_per_video(self) -> int:
        denum = self.fg_ratio + self.bg_ratio + self.incomplete_ratio
        return int(self.prop_per_video * (self.bg_ratio / denum))

    @property
    def incomplete_per_video(self) -> int:
        return self.prop_per_video - self.fg_per_video - self.bg_per_video


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    top_k: int = 2000
    nms_threshold: float = 0.2
    softmax_before_filter: bool = True


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str
    train_list: str
    test_list: str
    num_class: int
    sampling: SamplingConfig
    evaluation: EvalConfig
    stpp: Tuple[StageCfg, StageCfg, StageCfg] = (1, 1, 1)
    # published pretrained-init URLs: flow_init[arch], kinetics_pretrain[arch][modality]
    flow_init: dict = dataclasses.field(default_factory=dict)
    kinetics_pretrain: dict = dataclasses.field(default_factory=dict)

    @property
    def iou_range(self):
        """The mAP IoU sweep grid (eval_detection_results.py:209-214)."""
        import numpy as np

        if self.name.startswith("activitynet"):
            return np.arange(0.5, 1.0, 0.05)
        if self.name.startswith("thumos"):
            return np.arange(0.1, 1.0, 0.1)
        raise ValueError(f"unknown dataset {self.name}")


_MODELS = "https://yjxiong.blob.core.windows.net/ssn-models/"
_KINETICS = {
    "BNInception": {
        "RGB": _MODELS + "bninception_rgb_kinetics_init-d4ee618d3399.pth",
        "Flow": _MODELS + "bninception_flow_kinetics_init-1410c1ccb470.pth"},
    "InceptionV3": {
        "RGB": _MODELS + "inceptionv3_rgb_kinetics_init-c42e70a05e22.pth",
        "Flow": _MODELS + "inceptionv3_flow_kinetics_init-374d56ea4e66.pth"},
}

DATASETS = {
    "thumos14": DatasetConfig(
        name="thumos14",
        train_list="thumos14_tag_val",
        test_list="thumos14_tag_test",
        num_class=20,
        # THUMOS14 deliberately includes more incomplete samples
        sampling=SamplingConfig(incomplete_overlap_thresh=0.01),
        evaluation=EvalConfig(top_k=2000, nms_threshold=0.2,
                              softmax_before_filter=True),
        stpp=(1, 1, 1),
        flow_init={
            "BNInception": _MODELS
            + "bninception_thumos_flow_init-89dfeaf803e.pth",
            "InceptionV3": _MODELS
            + "inceptionv3_thumos_flow_init-0527856bcec6.pth"},
        kinetics_pretrain=_KINETICS),
    "activitynet1.2": DatasetConfig(
        name="activitynet1.2",
        train_list="activitynet1.2_tag_train",
        test_list="activitynet1.2_tag_val",
        num_class=100,
        sampling=SamplingConfig(),
        evaluation=EvalConfig(top_k=60, nms_threshold=0.6,
                              softmax_before_filter=False),
        stpp=(1, 1, 1),
        flow_init={
            "BNInception": _MODELS
            + "bninception_activitynet1.2_flow_init-0090e716bd1563.pth",
            "InceptionV3": _MODELS
            + "inceptionv3_activitynet1.2_flow_init-cd9437aaedfb.pth"},
        kinetics_pretrain=_KINETICS),
}


def get_configs(dataset: str) -> DatasetConfig:
    """The detection-task config for a dataset."""
    try:
        return DATASETS[dataset]
    except KeyError:
        raise ValueError(f"unknown dataset {dataset!r} "
                         f"(known: {sorted(DATASETS)})") from None
