"""Video dataset databases: ActivityNet (JSON taxonomy) and THUMOS (txt annos).

A host copy of ``action_detection_tpu/data/video_db.py``: one shared
Instance/Video abstraction, alphabetically-ordered numeric class ids, subset
splits, and best-effort frame-folder path attachment.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Instance:
    """One annotated activity instance inside a video.

    Plain record: a string class label (plus its numeric id under the DB's
    alphabetical taxonomy), a ``[start, end]`` time span in seconds, and the
    duration of the containing video for coverage math.
    """

    label: str
    start: float
    end: float
    video_duration: float
    num_label: Optional[int] = None

    @property
    def time_span(self) -> Tuple[float, float]:
        return self.start, self.end

    @property
    def covering_ratio(self) -> Tuple[float, float]:
        return (self.start / float(self.video_duration),
                self.end / float(self.video_duration))


@dataclasses.dataclass
class Video:
    """One video with its annotations and (optionally) its frame folder."""

    id: str
    duration: float
    subset: str
    instances: List[Instance] = dataclasses.field(default_factory=list)
    url: Optional[str] = None
    path: Optional[str] = None


def _make_video(key: str, duration: float, subset: str, annotations,
                name_idx_mapping, url=None) -> Video:
    """Build a Video from ``{label, segment}`` annotation dicts."""
    instances = [
        Instance(label=a["label"], start=a["segment"][0], end=a["segment"][1],
                 video_duration=duration,
                 num_label=(name_idx_mapping[a["label"]]
                            if name_idx_mapping else None))
        for a in annotations]
    return Video(id=key, duration=duration, subset=subset,
                 instances=instances, url=url)


class ANetDB:
    """ActivityNet database from the official min-JSON dump.

    Classes are the taxonomy's leaf nodes in alphabetical order
    (anet_db.py:185-197).
    """

    def __init__(self, db_file: str):
        with open(db_file) as f:
            raw = json.load(f)
        self.version = raw["version"]
        self._parse_taxonomy(raw["taxonomy"])
        self._database = raw["database"]
        self._video_dict = {
            k: _make_video(k, float(v["duration"]), v["subset"],
                           v["annotations"], self._name_idx_table,
                           url=v.get("url"))
            for k, v in self._database.items()}
        self._subsets: Dict[str, "OrderedDict[str, Video]"] = {}
        for subset in ("training", "validation", "testing"):
            self._subsets[subset] = OrderedDict(
                sorted(((k, v) for k, v in self._video_dict.items()
                        if v.subset == subset), key=lambda x: x[0]))

    @classmethod
    def get_db(cls, version: str = "1.2", data_dir: str = "data") -> "ANetDB":
        if version not in ("1.2", "1.3"):
            raise ValueError(f"Unsupported database version {version}")
        path = os.path.join(
            data_dir, "activity_net.v{}.min.json".format("-".join(version.split("."))))
        return cls(path)

    def _parse_taxonomy(self, taxonomy) -> None:
        name_dict = {x["nodeName"]: x for x in taxonomy}
        parents = {x["parentName"] for x in taxonomy}
        leaf_nodes = [name_dict[x] for x in set(name_dict) - parents]
        sorted_leaves = sorted(leaf_nodes, key=lambda n: n["nodeName"])
        self._idx_name_table = {i: n["nodeName"] for i, n in enumerate(sorted_leaves)}
        self._name_idx_table = {n["nodeName"]: i for i, n in enumerate(sorted_leaves)}

    def get_subset_videos(self, subset_name: str) -> List[Video]:
        if subset_name not in self._subsets:
            raise ValueError(f"Unknown subset {subset_name}")
        return list(self._subsets[subset_name].values())

    def get_subset_instance(self, subset_name: str) -> List[Instance]:
        return [i for v in self.get_subset_videos(subset_name) for i in v.instances]

    def get_ordered_label_list(self) -> List[str]:
        return [self._idx_name_table[i] for i in sorted(self._idx_name_table)]

    def try_load_file_path(self, frame_path: str) -> int:
        folders = glob.glob(os.path.join(frame_path, "*"))
        folder_dict = {os.path.splitext(name)[0][-11:]: name for name in folders}
        cnt = 0
        for k, v in self._video_dict.items():
            if k in folder_dict:
                v.path = folder_dict[k]
                cnt += 1
        return cnt


class THUMOSDB:
    """THUMOS14/15 database from per-class temporal annotation files."""

    def __init__(self, db_folder: str, year: int = 14,
                 ignore_labels=("Ambiguous",)):
        self.year = year
        self.ignore_labels = list(ignore_labels)
        self._validation_info = self._load_subset_info(db_folder, "validation")
        self._test_info = self._load_subset_info(db_folder, "test")
        self._parse_taxonomy()
        self._validation_dict = self._construct_video_dict(
            self._validation_info, "validation")
        self._test_dict = self._construct_video_dict(self._test_info, "test")
        self._video_dict = {**self._validation_dict, **self._test_dict}

    @classmethod
    def get_db(cls, year: int = 14, data_dir: str = "data") -> "THUMOSDB":
        if year not in (14, 15):
            raise ValueError(f"Unsupported challenge year {year}")
        return cls(os.path.join(data_dir, f"thumos_{year}"), year)

    @staticmethod
    def _load_subset_info(db_folder: str, subset: str):
        duration_file = os.path.join(db_folder, f"{subset}_durations.txt")
        annotation_files = glob.glob(
            os.path.join(db_folder, f"temporal_annotations_{subset}", "*"))
        avoid_file = os.path.join(db_folder, f"{subset}_avoid_videos.txt")

        with open(duration_file) as f:
            durations_lines = [x.strip() for x in f]
        annotation_list = []
        for fp in annotation_files:
            with open(fp) as f:
                annotation_list.append((os.path.basename(fp).split("_")[0], list(f)))
        with open(avoid_file) as f:
            avoid_set = {"-".join(x.strip().split()) for x in f}

        video_names = [durations_lines[i].split(".")[0]
                       for i in range(0, len(durations_lines), 2)]
        video_durations = [durations_lines[i]
                           for i in range(1, len(durations_lines), 2)]
        video_info = list(zip(video_names, video_durations))
        duration_dict = dict(video_info)

        video_table: Dict[str, list] = {v: [] for v in video_names}
        for cls_name, annotations in annotation_list:
            for a in annotations:
                items = a.strip().split()
                vid, st, ed = items[0], float(items[1]), float(items[2])
                if (f"{vid}-{cls_name}" not in avoid_set
                        and st <= float(duration_dict[vid])):
                    video_table[vid].append((cls_name, st, ed))
        return video_info, video_table, annotation_files

    def _parse_taxonomy(self) -> None:
        val_names = sorted(os.path.split(x)[1].split("_")[0]
                           for x in self._validation_info[-1])
        test_names = sorted(os.path.split(x)[1].split("_")[0]
                            for x in self._test_info[-1])
        if val_names != test_names:
            raise IOError("validation and test class lists differ")
        final = sorted(n for n in val_names if n not in self.ignore_labels)
        self._idx_name_table = dict(enumerate(final))
        self._name_idx_table = {n: i for i, n in enumerate(final)}

    def _construct_video_dict(self, info, subset: str) -> Dict[str, Video]:
        video_info, annotation_table, _ = info
        out = {}
        for name, duration in video_info:
            annotations = [{"label": item[0], "segment": (item[1], item[2])}
                           for item in annotation_table[name]
                           if item[0] not in self.ignore_labels]
            out[name] = _make_video(name, float(duration), subset, annotations,
                                    self._name_idx_table)
        return out

    def get_subset_videos(self, subset_name: str) -> List[Video]:
        if subset_name == "validation":
            return list(self._validation_dict.values())
        if subset_name == "test":
            return list(self._test_dict.values())
        raise ValueError(f"Unknown subset {subset_name}")

    def get_subset_instance(self, subset_name: str) -> List[Instance]:
        return [i for v in self.get_subset_videos(subset_name) for i in v.instances]

    def get_ordered_label_list(self) -> List[str]:
        return [self._idx_name_table[i] for i in sorted(self._idx_name_table)]

    def try_load_file_path(self, frame_path: str) -> int:
        folders = glob.glob(os.path.join(frame_path, "*"))
        folder_dict = {os.path.split(name)[-1]: name for name in folders}
        cnt = 0
        for k, v in self._video_dict.items():
            if k in folder_dict:
                v.path = folder_dict[k]
                cnt += 1
        return cnt
