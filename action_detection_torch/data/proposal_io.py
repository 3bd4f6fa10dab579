"""Proposal-list interchange format.

This is the central text format connecting proposal generation, training and
evaluation. A host copy of the parser in
``action_detection_tpu/data/proposal_io.py``; its data-preparation tools
(``process_proposal_list``, ``parse_directory``, ``dump_window_list``) come
to the port with the proposal-generation CLIs.

A file is a sequence of groups, each introduced by a ``#`` comment line::

    # <index>
    <video path or id>
    <duration (frames or seconds)>
    <fps>
    <num groundtruth>
    <label> <start> <end>          (num groundtruth rows)
    <num proposals>
    <label> <best_iou> <overlap_self> <start> <end>   (num proposal rows)

``frame_count = int(duration * fps)``.
"""

from __future__ import annotations

from itertools import groupby
from typing import List, Tuple

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
