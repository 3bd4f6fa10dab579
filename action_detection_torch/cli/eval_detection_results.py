"""Detection mAP evaluation CLI (host; torch port of
``action_detection_tpu/cli/eval_detection_results.py``).

Usage: python -m action_detection_torch.cli.eval_detection_results
       <dataset> <pickle> [<pickle> ...] [flags]

Same flags as the JAX CLI. The side outputs ``gt_dump.pc`` and
``pred_dump.pc`` (pandas DataFrames, written to the working directory) are
written only where pandas imports; otherwise one line says they were
skipped. The AP table does not depend on pandas. Imports no torch.
"""

from __future__ import annotations

import argparse
import os
import pickle


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate detection performance metrics")
    parser.add_argument("dataset", type=str,
                        choices=["activitynet1.2", "thumos14"])
    parser.add_argument("detection_pickles", type=str, nargs="+")
    parser.add_argument("--nms_threshold", type=float, default=None)
    parser.add_argument("--no_regression", default=False, action="store_true")
    parser.add_argument("--softmax_before_filter", default=False,
                        action="store_true")
    parser.add_argument("-j", "--ap_workers", type=int, default=32)
    parser.add_argument("--top_k", type=int, default=None)
    parser.add_argument("--cls_scores", type=str, default=None)
    parser.add_argument("--cls_top_k", type=int, default=1)
    parser.add_argument("--score_weights", type=float, default=None, nargs="+")
    parser.add_argument("--prop_file_dir", default="data", type=str)
    parser.add_argument("--dump_detections", type=str, default=None)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..config import get_configs
    from ..data.ssn_dataset import SSNDataset
    from ..evaluation import (apply_classwise_nms, evaluate_detections,
                              format_map_table, generate_detections,
                              merge_score_dicts)
    from ..evaluation.detection import apply_regression

    cfg = get_configs(args.dataset)
    num_class = cfg.num_class
    nms_threshold = (args.nms_threshold if args.nms_threshold is not None
                     else cfg.evaluation.nms_threshold)
    top_k = args.top_k if args.top_k is not None else cfg.evaluation.top_k
    softmax_bf = (args.softmax_before_filter
                  or cfg.evaluation.softmax_before_filter)

    print(f"initiating evaluation of detection results {args.detection_pickles}")
    score_dicts = []
    for pc in args.detection_pickles:
        with open(pc, "rb") as f:
            score_dicts.append(pickle.load(f))
    detection_scores = merge_score_dicts(score_dicts, args.score_weights)
    print(f"merged detection scores from {len(score_dicts)} sources")

    cls_score_dict = None
    if args.cls_scores:
        with open(args.cls_scores, "rb") as f:
            raw = pickle.load(f, encoding="bytes")
        cls_score_dict = {}
        for k, v in raw.items():
            key = k.decode("utf-8") if isinstance(k, bytes) else k
            cls_score_dict[os.path.splitext(os.path.basename(key))[0]] = v
        print(f"using classifier scores from {args.cls_scores}")

    dets = generate_detections(detection_scores, num_class, top_k=top_k,
                               softmax_before_filter=softmax_bf,
                               cls_score_dict=cls_score_dict,
                               cls_top_k=args.cls_top_k)
    print("detections generated; performing NMS...")
    dets = apply_classwise_nms(dets, nms_threshold)
    if not args.no_regression:
        print("performing location regression...")
        dets = apply_regression(dets)

    test_prop_file = os.path.join(args.prop_file_dir,
                                  f"{cfg.test_list}_proposal_list.txt")
    dataset = SSNDataset(test_prop_file, cfg.sampling, verbose=False)
    all_gt = dataset.get_all_gt()

    if args.dump_detections:
        with open(args.dump_detections, "wb") as f:
            pickle.dump(dets, f, pickle.HIGHEST_PROTOCOL)

    write_side_dumps(all_gt, dets, num_class)

    iou_range = cfg.iou_range
    ap_values = evaluate_detections(dets, all_gt, num_class, iou_range,
                                    workers=args.ap_workers)
    print(format_map_table(iou_range, ap_values,
                           title=f"Detection Performance on {args.dataset}"))
    return ap_values


def write_side_dumps(all_gt, dets, num_class: int) -> None:
    """The reference's side outputs for external analysis scripts
    (eval_detection_results.py:189-206): per-class GT and raveled detection
    DataFrames, written to the working directory where pandas imports."""
    try:
        import pandas as pd
    except ImportError:
        print("pandas is not installed: gt_dump.pc and pred_dump.pc skipped")
        return

    all_gt_df = pd.DataFrame(all_gt,
                             columns=["video-id", "cls", "t-start", "t-end"])
    gt_by_cls = [all_gt_df[all_gt_df.cls == cls]
                 .reset_index(drop=True).drop(columns="cls")
                 for cls in range(num_class)]
    plain_detections = [
        pd.DataFrame([[vid, cls] + list(row[:3])
                      for vid, arr in dets[cls].items() for row in arr.tolist()],
                     columns=["video-id", "cls", "t-start", "t-end", "score"])
        for cls in range(num_class)]
    with open("gt_dump.pc", "wb") as f:
        pickle.dump(gt_by_cls, f, pickle.HIGHEST_PROTOCOL)
    with open("pred_dump.pc", "wb") as f:
        pickle.dump(plain_detections, f, pickle.HIGHEST_PROTOCOL)


if __name__ == "__main__":
    main()
