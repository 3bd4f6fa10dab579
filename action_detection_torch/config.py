"""Dataset-level configuration as Python constants.

The values of ``action_detection_tpu/configs/dataset_cfg.yaml`` (the
detection task) and ``dataset_actionness_cfg.yaml`` (the binary actionness
task of TAG) for the two datasets, held as typed dataclasses so the port
needs no yaml parser (the machines it runs on have none).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

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


# the actionness (TAG) task: sliding-window lists, 3:9 fg:bg sampling and
# no incomplete proposals; the ActivityNet model has a 100-wide head trained
# on 0/1 fg/bg targets (reference binary_model.py:124)
_ACTIONNESS_SAMPLING = dict(prop_per_video=12, fg_ratio=3, bg_ratio=9,
                            incomplete_ratio=0)
ACTIONNESS_DATASETS = {
    "thumos14": dataclasses.replace(
        DATASETS["thumos14"], train_list="thumos14_sw_val",
        test_list="thumos14_sw_test", num_class=2,
        sampling=SamplingConfig(incomplete_overlap_thresh=0.01,
                                **_ACTIONNESS_SAMPLING)),
    "activitynet1.2": dataclasses.replace(
        DATASETS["activitynet1.2"], train_list="activitynet1.2_sw_train",
        test_list="activitynet1.2_sw_val",
        sampling=SamplingConfig(**_ACTIONNESS_SAMPLING)),
}


def _lookup(table: dict, dataset: str) -> DatasetConfig:
    try:
        return table[dataset]
    except KeyError:
        raise ValueError(f"unknown dataset {dataset!r} "
                         f"(known: {sorted(table)})") from None


def get_configs(dataset: str) -> DatasetConfig:
    """The detection-task config for a dataset."""
    return _lookup(DATASETS, dataset)


def get_actionness_configs(dataset: str) -> DatasetConfig:
    """The binary-actionness-task (TAG) config for a dataset."""
    return _lookup(ACTIONNESS_DATASETS, dataset)


def pretrained_cache_dir() -> str:
    """Where published pretrained checkpoints are looked up (the reference's
    model_zoo cache): ``$ADT_MODEL_CACHE``, else
    ``~/.cache/action_detection_tpu``, the JAX package's rule, so one cache
    serves both packages."""
    return os.environ.get(
        "ADT_MODEL_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache",
                     "action_detection_tpu"))


def resolve_pretrained_init(cfg: DatasetConfig, arch: str, modality: str,
                            kinetics: bool = False) -> Optional[str]:
    """A published pretrained-init URL -> its cached local ``.pth`` path.

    None for plain RGB (the reference starts from its backbone
    constructor's ImageNet weights; there is no file to look up);
    ``KeyError`` for an arch the config has no URL for; ``FileNotFoundError``
    naming the path when the file is not in the cache. Nothing is
    downloaded.
    """
    if kinetics:
        try:
            url = cfg.kinetics_pretrain[arch][modality]
        except KeyError:
            raise KeyError(f"no kinetics_pretrain URL for arch={arch} "
                           f"modality={modality} in dataset "
                           f"'{cfg.name}'") from None
    elif modality == "Flow":
        try:
            url = cfg.flow_init[arch]
        except KeyError:
            raise KeyError(f"no flow_init URL for arch={arch} in dataset "
                           f"'{cfg.name}'") from None
    else:
        return None
    return _cached(url, "pretrained init checkpoint")


def _cached(url: str, what: str) -> str:
    """The path of ``url``'s file name in :func:`pretrained_cache_dir`;
    ``FileNotFoundError`` naming the path when it is not there."""
    path = os.path.join(pretrained_cache_dir(), url.rsplit("/", 1)[-1])
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{what} not cached: {path}\n"
            f"Nothing is downloaded here. Fetch\n  {url}\nout of band and "
            f"place it at that path (or set $ADT_MODEL_CACHE).")
    return path


_REFERENCE = "https://yjxiong.blob.core.windows.net/ssn-reference-models/"
#: the published reference SSN checkpoints (the values of
#: ``action_detection_tpu/configs/reference_models.yaml``):
#: dataset -> init -> arch -> modality -> URL
REFERENCE_MODELS = {
    "thumos14": {
        "ImageNet": {
            "BNInception": {
                "RGB": _REFERENCE + "ssn_reference_thumos14_bninception_rgb"
                                    "-74e71b25d64a.pth.tar",
                "Flow": _REFERENCE + "ssn_reference_thumos14_bninception_"
                                     "flow-dfe7aba61375.pth.tar"},
            "InceptionV3": {
                "RGB": _REFERENCE + "ssn_reference_thumos14_inceptionv3_rgb"
                                    "-20e223da6fb7.pth.tar",
                "Flow": _REFERENCE + "ssn_reference_thumos14_inceptionv3_"
                                     "flow-918f932dd160.pth.tar"}},
        "Kinetics": {
            "BNInception": {
                "RGB": _REFERENCE + "ssn_kinetics_reference_thumos14_"
                                    "bninception_rgb-9864666d118b.pth.tar",
                "Flow": _REFERENCE + "ssn_kinetics_reference_thumos14_"
                                     "bninception_flow-d4974e0142ea.pth.tar"},
            "InceptionV3": {
                "RGB": _REFERENCE + "ssn_kinetics_reference_thumos14_"
                                    "inceptionv3_rgb-22568ca50690.pth.tar",
                "Flow": _REFERENCE + "ssn_kinetics_reference_thumos14_"
                                     "inceptionv3_flow-e09c5c9cd1ee.pth.tar"}}},
    "activitynet1.2": {
        "ImageNet": {
            "BNInception": {
                "RGB": _REFERENCE + "ssn_reference_activitynet1.2_"
                                    "bninception_rgb-e2fd10a6c6b0.pth.tar",
                "Flow": _REFERENCE + "ssn_reference_activitynet1.2_"
                                     "bninception_flow-dfcdda9fe1f5.pth.tar"}}},
}


def get_reference_model_url(dataset: str, modality: str, init: str,
                            arch: str) -> str:
    """The published reference checkpoint's URL; ``init`` is ``ImageNet``
    or ``Kinetics``. A combination with no published model raises
    ``KeyError``, as the JAX package's lookup does."""
    return REFERENCE_MODELS[dataset][init][arch][modality]


def resolve_reference_checkpoint(dataset: str, modality: str, init: str,
                                 arch: str) -> str:
    """``--use_reference`` / ``--use_kinetics_reference``: the published
    checkpoint's file name in :func:`pretrained_cache_dir`, where the
    reference's download would have put it; ``FileNotFoundError`` naming the
    path when it is not there. Nothing is downloaded."""
    return _cached(get_reference_model_url(dataset, modality, init, arch),
                   "reference checkpoint")
