"""Adapt normalized proposal lists to a local frame extraction (host; torch
port of ``action_detection_tpu/cli/gen_proposal_list.py``, same flags).
Imports no torch."""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Denormalize proposal lists against local frame folders")
    parser.add_argument("dataset", type=str,
                        choices=["activitynet1.2", "thumos14"])
    parser.add_argument("frame_path", type=str)
    parser.add_argument("--data_dir", type=str, default="data",
                        help="directory of normalized lists / output lists")
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..data.proposal_io import parse_directory, process_proposal_list

    if args.dataset == "thumos14":
        key_func = os.path.basename  # video_test_0000001-style names
        lists = ["thumos14_tag_val", "thumos14_tag_test"]
    else:
        key_func = lambda x: x.split("/")[-1][-11:]  # v_XXXXXXXXXXX ids
        lists = ["activitynet1.2_tag_train", "activitynet1.2_tag_val"]

    print(f"parsing frames under {args.frame_path}")
    frame_dict = parse_directory(args.frame_path, key_func=key_func)
    print(f"found {len(frame_dict)} frame folders")

    for name in lists:
        norm = os.path.join(args.data_dir, f"{name}_normalized_proposal_list.txt")
        out = os.path.join(args.data_dir, f"{name}_proposal_list.txt")
        if not os.path.exists(norm):
            print(f"skip {norm} (missing)")
            continue
        process_proposal_list(norm, out, frame_dict)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
