"""TAG bottom-up proposal generation CLI (host; torch port of
``action_detection_tpu/cli/gen_bottom_up_proposals.py``, same flags).

Consumes dense actionness score pickles (binary_test output), merges streams,
groups fg frames into proposals with multi-threshold flood-fill search (the
C++ host library), NMS@0.9, reports recall, and optionally writes a proposal
list. Imports no torch. With ``--workers`` > 1 the videos fan out on a
process pool that starts its workers with ``spawn``, never ``fork``, so the
CLI is safe inside a process that has initialised CUDA; the host-kernel
launch counts of those workers stay in the workers (``--workers 1`` keeps
every call in this process). A script that calls :func:`main` with
``--workers`` > 1 needs an ``if __name__ == "__main__":`` guard: spawned
workers import the caller's main module.
"""

from __future__ import annotations

import argparse
import multiprocessing
import pickle
from concurrent.futures import ProcessPoolExecutor

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("score_files", type=str, nargs="+")
    parser.add_argument("--anet_version", type=str, default="1.2")
    parser.add_argument("--dataset", type=str, default="activitynet",
                        choices=["activitynet", "thumos14"])
    parser.add_argument("--subset", type=str, default="validation",
                        choices=["training", "validation", "testing"])
    parser.add_argument("--iou_thresh", type=float, nargs="+",
                        default=[0.5, 0.75, 0.95])
    parser.add_argument("--score_weights", type=float, nargs="+", default=None)
    parser.add_argument("--write_proposals", type=str, default=None)
    parser.add_argument("--minimum_len", type=float, default=0,
                        help="minimum length of a proposal, in seconds")
    parser.add_argument("--frame_path", type=str, default="")
    parser.add_argument("--data_dir", type=str, default="data")
    parser.add_argument("--workers", type=int, default=16)
    parser.add_argument("--thresholds", type=float, nargs="+",
                        default=[0.01, 0.05, 0.1, 0.15, 0.25, 0.4, 0.5, 0.6,
                                 0.7, 0.8, 0.9, 0.95])
    parser.add_argument("--tolerances", type=float, nargs="+",
                        default=[0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.8, 1.0])
    parser.add_argument("--smoothing_bw", type=float, default=3)
    return parser


def gen_prop_for_video(task):
    """Per-video proposal generation (picklable for process pools)."""
    from ..ops.nms import temporal_nms_tuples
    from ..ops.tag import build_box_by_search, label_frame_by_threshold

    vid, scores, duration, thresholds, tolerances, bw, minimum_len = task
    frm_duration = len(scores)
    labels = label_frame_by_threshold(scores, [0], bw=bw,
                                      thresh=list(thresholds), multicrop=False)
    boxes = build_box_by_search(labels, np.array(tolerances))
    boxes = temporal_nms_tuples(boxes, 0.9)
    pr_box = [(x[0] / float(frm_duration) * duration,
               x[1] / float(frm_duration) * duration) for x in boxes]
    keep = [i for i, b in enumerate(pr_box) if b[1] - b[0] > minimum_len]
    return vid, [pr_box[i] for i in keep], [boxes[i][3] for i in keep]


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data.proposal_io import dump_window_list
    from ..data.video_db import ANetDB, THUMOSDB
    from ..ops.iou import get_temporal_proposal_recall, name_proposal

    if args.dataset == "activitynet":
        db = ANetDB.get_db(args.anet_version, data_dir=args.data_dir)
    else:
        db = THUMOSDB.get_db(data_dir=args.data_dir)
        if args.subset == "testing":
            args.subset = "test"
    if args.frame_path:
        db.try_load_file_path(args.frame_path)

    video_list = [v for v in db.get_subset_videos(args.subset) if v.instances]
    print(f"video list size: {len(video_list)}")

    score_list = []
    for fname in args.score_files:
        with open(fname, "rb") as f:
            score_list.append(pickle.load(f))
    print(f"loaded {len(score_list)} piles of scores")

    # merge streams: crop-mean per pile, length-aligned weighted sum
    score_dict = {}
    weights = args.score_weights or [1.0] * len(score_list)
    for key in score_list[0]:
        out = score_list[0][key].mean(axis=1) * weights[0]
        for i in range(1, len(score_list)):
            add = score_list[i][key].mean(axis=1)
            if add.shape[0] < out.shape[0]:
                out = out[:add.shape[0], :]
            elif add.shape[0] > out.shape[0]:
                tick = add.shape[0] / float(out.shape[0])
                add = add[[int(x * tick) for x in range(out.shape[0])], :]
            out = out + add * weights[i]
        score_dict[key] = out

    tasks = [(v.id, score_dict[v.id], v.duration, args.thresholds,
              args.tolerances, args.smoothing_bw, args.minimum_len)
             for v in video_list if v.id in score_dict]
    pr_dict, pr_score_dict = {}, {}
    if args.workers > 1:
        with ProcessPoolExecutor(
                max_workers=args.workers,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            for vid, boxes, scores in pool.map(gen_prop_for_video, tasks):
                pr_dict[vid], pr_score_dict[vid] = boxes, scores
    else:
        for task in tasks:
            vid, boxes, scores = gen_prop_for_video(task)
            pr_dict[vid], pr_score_dict[vid] = boxes, scores

    used = [v for v in video_list if v.id in pr_dict]
    proposal_list = [pr_dict[v.id] for v in used]
    gt_spans_full = [[(x.num_label, x.time_span) for x in v.instances] for v in used]
    gt_spans = [[it[1] for it in x] for x in gt_spans_full]
    print("average # of proposals: {}".format(
        np.mean([len(p) for p in proposal_list])))

    p_list = []
    for th in np.arange(0.5, 1, 0.2):
        pv, pi = get_temporal_proposal_recall(proposal_list, gt_spans, th)
        print("IOU threshold {:.1f}. per video recall: {:02f}, "
              "per instance recall: {:02f}".format(th, pv * 100, pi * 100))
        p_list.append((pv, pi))
    print("Average Recall: {:.04f} {:.04f}".format(
        *(np.mean(p_list, axis=0) * 100)))

    if args.write_proposals:
        name_pattern = "img_*.jpg"
        named = [name_proposal(x, y) for x, y in zip(gt_spans_full, proposal_list)]
        allow_empty = args.dataset == "activitynet" and args.subset == "testing"
        dumped = [dump_window_list(v, prs, args.frame_path, name_pattern,
                                   score=score_dict[v.id],
                                   allow_empty=allow_empty)
                  for v, prs in zip(used, named)]
        with open(args.write_proposals, "w") as of:
            for i, e in enumerate(dumped):
                of.write(f"# {i + 1}\n")
                of.write(e)
        print(f"list written. got {len(dumped)} videos")


if __name__ == "__main__":
    main()
