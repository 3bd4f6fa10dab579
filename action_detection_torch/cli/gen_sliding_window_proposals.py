"""Sliding-window proposal generation CLI (host; torch port of
``action_detection_tpu/cli/gen_sliding_window_proposals.py``, same flags).

Writes the ``<dataset>_sw_<subset>`` proposal list that ``binary_test``
scores: exponential windows per video of the dataset DB, named against the
ground truth, frame counts from the extracted frame folders. Imports no
torch.
"""

from __future__ import annotations

import argparse

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Make window file used for detection")
    parser.add_argument("subset")
    parser.add_argument("modality", choices=["rgb", "flow"])
    parser.add_argument("frame_path")
    parser.add_argument("output_file")
    parser.add_argument("--overlap", type=float, default=0.7)
    parser.add_argument("--max_level", type=int, default=8)
    parser.add_argument("--time_step", type=float, default=1)
    parser.add_argument("--version", default="1.2")
    parser.add_argument("--avoid", default=None, type=str)
    parser.add_argument("--dataset", default="activitynet",
                        choices=["thumos14", "activitynet"])
    parser.add_argument("--data_dir", default="data", type=str)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data.proposal_io import dump_window_list
    from ..data.video_db import ANetDB, THUMOSDB
    from ..ops.iou import get_temporal_proposal_recall, name_proposal
    from ..ops.tag import gen_exponential_sw_proposal

    name_pattern = "img_*.jpg" if args.modality == "rgb" else "flow_x_*.jpg"

    if args.dataset == "activitynet":
        db = ANetDB.get_db(args.version, data_dir=args.data_dir)
    else:
        db = THUMOSDB.get_db(data_dir=args.data_dir)
        if args.subset == "testing":
            args.subset = "test"
    db.try_load_file_path(args.frame_path)

    avoid_list = ([x.strip() for x in open(args.avoid)] if args.avoid else [])

    videos = db.get_subset_videos(args.subset)
    gt_spans = [[(x.num_label, x.time_span) for x in v.instances] for v in videos]
    proposal_list = [gen_exponential_sw_proposal(
        v.duration, overlap=args.overlap, time_step=args.time_step,
        max_level=args.max_level) for v in videos]
    print("average # of proposals: {} at overlap param {}".format(
        np.mean([len(p) for p in proposal_list]), args.overlap))

    named = [name_proposal(x, y) for x, y in zip(gt_spans, proposal_list)]
    for th in (0.5, 0.7, 0.9):
        pv, pi = get_temporal_proposal_recall(
            proposal_list, [[y[1] for y in x] for x in gt_spans], th)
        print("IOU threshold {}. per video recall: {:02f}, "
              "per instance recall: {:02f}".format(th, pv * 100, pi * 100))

    dumped = [dump_window_list(v, prs, args.frame_path, name_pattern)
              for v, prs in zip(videos, named) if v.id not in avoid_list]
    with open(args.output_file, "w") as of:
        for i, e in enumerate(dumped):
            of.write(f"# {i + 1}\n")
            of.write(e)
    print(f"list written. got {len(dumped)} videos")


if __name__ == "__main__":
    main()
