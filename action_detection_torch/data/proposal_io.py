"""Proposal-list interchange format.

This is the central text format connecting proposal generation, training and
evaluation. A host copy of ``action_detection_tpu/data/proposal_io.py``.

A file is a sequence of groups, each introduced by a ``#`` comment line::

    # <index>
    <video path or id>
    <duration (frames or seconds)>
    <fps>
    <num groundtruth>
    <label> <start> <end>          (num groundtruth rows)
    <num proposals>
    <label> <best_iou> <overlap_self> <start> <end>   (num proposal rows)

``frame_count = int(duration * fps)``. Normalized lists store start/end as
fractions of the video; :func:`process_proposal_list` denormalizes them to a
local frame extraction.
"""

from __future__ import annotations

import fnmatch
import glob
import os
from itertools import groupby
from typing import Callable, Dict, List, Sequence, Tuple

ProposalGroup = Tuple[str, int, List[List[str]], List[List[str]]]


def load_proposal_file(filename: str) -> List[ProposalGroup]:
    """Parse a proposal list into ``(vid, frame_count, gt_rows, prop_rows)`` tuples.

    ``gt_rows`` are ``[label, start, end]`` token lists; ``prop_rows`` are
    ``[label, best_iou, overlap_self, start, end]`` token lists (kept as
    strings, mirroring the lazy parse of the reference format).
    """
    with open(filename) as f:
        lines = list(f)
    groups = groupby(lines, lambda x: x.startswith("#"))
    info_list = [[x.strip() for x in list(g)] for is_comment, g in groups if not is_comment]

    def parse_group(info: List[str]) -> ProposalGroup:
        vid = info[0]
        n_frame = int(float(info[1]) * float(info[2]))
        n_gt = int(info[3])
        offset = 4
        gt_boxes = [x.split() for x in info[offset:offset + n_gt]]
        offset += n_gt
        n_pr = int(info[offset])
        offset += 1
        pr_boxes = [x.split() for x in info[offset:offset + n_pr]]
        return vid, n_frame, gt_boxes, pr_boxes

    return [parse_group(info) for info in info_list]


def process_proposal_list(norm_proposal_list: str, out_list_name: str,
                          frame_dict: Dict[str, Tuple[str, int, int]]) -> None:
    """Denormalize a fraction-coordinate proposal list to local frame counts.

    ``frame_dict`` maps video id -> ``(frame_path, n_rgb_frames, n_flow_frames)``
    as produced by :func:`parse_directory`.
    """
    norm_proposals = load_proposal_file(norm_proposal_list)

    processed = []
    for idx, prop in enumerate(norm_proposals):
        vid = prop[0]
        frame_path, frame_cnt = frame_dict[vid][0], frame_dict[vid][1]

        gt = [[int(x[0]), int(float(x[1]) * frame_cnt), int(float(x[2]) * frame_cnt)]
              for x in prop[2]]
        pr = [[int(x[0]), float(x[1]), float(x[2]),
               int(float(x[3]) * frame_cnt), int(float(x[4]) * frame_cnt)]
              for x in prop[3]]

        gt_dump = "\n".join("{} {:d} {:d}".format(*x) for x in gt) + ("\n" if gt else "")
        pr_dump = "\n".join("{} {:.04f} {:.04f} {:d} {:d}".format(*x) for x in pr) + (
            "\n" if pr else "")
        processed.append(
            "# {idx}\n{path}\n{fc}\n1\n{num_gt}\n{gt}{num_prop}\n{prop}".format(
                idx=idx, path=frame_path, fc=frame_cnt,
                num_gt=len(gt), gt=gt_dump, num_prop=len(pr), prop=pr_dump))

    with open(out_list_name, "w") as f:
        f.writelines(processed)


def parse_directory(path: str, key_func: Callable[[str], str] = lambda x: x[-11:],
                    rgb_prefix: str = "img_", flow_x_prefix: str = "flow_x_",
                    flow_y_prefix: str = "flow_y_") -> Dict[str, Tuple[str, int, int]]:
    """Count RGB / flow frames in per-video directories of extracted frames."""
    frame_folders = glob.glob(os.path.join(path, "*"))

    def count_files(directory: str, prefixes: Sequence[str]) -> List[int]:
        names = os.listdir(directory)
        return [len(fnmatch.filter(names, p + "*")) for p in prefixes]

    frame_dict = {}
    for f in frame_folders:
        rgb_cnt, x_cnt, y_cnt = count_files(f, (rgb_prefix, flow_x_prefix, flow_y_prefix))
        if x_cnt != y_cnt:
            raise ValueError(
                "x and y direction have different number of flow images. video: " + f)
        frame_dict[key_func(f)] = (f, rgb_cnt, x_cnt)
    return frame_dict


def dump_window_list(video_info, named_proposals, frame_path: str, name_pattern: str,
                     allow_empty: bool = False, score=None) -> str:
    """Serialize one video's named proposals as a proposal-list group body.

    ``video_info`` is a dataset-DB video (``id``, ``duration``, ``instances``);
    ``named_proposals`` are the 5-tuples produced by
    :func:`action_detection_torch.ops.iou.name_proposal` in *seconds*.
    """
    try:
        video_name = video_info.path.split("/")[-1].split(".")[0]
        files = glob.glob(os.path.join(frame_path, video_name, name_pattern))
        frame_cnt = len(files)
    except Exception:
        if allow_empty:
            frame_cnt = score.shape[0] * 6
            video_name = video_info.id
        else:
            raise

    real_fps = float(frame_cnt) / float(video_info.duration)

    gt_windows = [(inst.num_label + 1,
                   int(inst.time_span[0] * real_fps), int(inst.time_span[1] * real_fps))
                  for inst in video_info.instances]
    dump_gt = ["{} {} {}".format(*gt) for gt in gt_windows]

    dump_proposals = [
        "{} {:.04f} {:.04f} {} {}".format(
            pr[0], pr[1], pr[2], int(pr[3] * real_fps), int(pr[4] * real_fps))
        for pr in named_proposals
    ]

    return "{path}\n{duration}\n{fps}\n{num_gt}\n{gts}{num_window}\n{prs}\n".format(
        path=os.path.join(frame_path, video_name), duration=frame_cnt, fps=1,
        num_gt=len(dump_gt), gts="\n".join(dump_gt) + ("\n" if dump_gt else ""),
        num_window=len(dump_proposals), prs="\n".join(dump_proposals))
