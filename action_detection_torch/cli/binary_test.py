"""Dense actionness scoring CLI (torch port of
``action_detection_tpu/cli/binary_test.py``).

Usage: python -m action_detection_torch.cli.binary_test <dataset> <modality>
       <training|validation|testing> <weights> <scores.pkl> [flags]

``weights`` is a port ``.pt``, a JAX ``checkpoint.msgpack`` or a reference
``.pth``/``.pth.tar`` of an actionness model
(``train/checkpoint.py:load_checkpoint``); ``--use_reference`` /
``--use_kinetics_reference`` resolve a published checkpoint in the local
model cache instead.

Scores every ``frame_interval``-th frame of each video of the actionness
proposal list with the binary actionness classifier and pickles
``{video basename: (ticks, crops, num_class)}`` raw logits for TAG grouping
(``num_class`` 2 for thumos14, 100 for activitynet1.2). Same flags and
defaults as the JAX CLI: int8 end to end with the shared stem for
BNInception and InceptionV3, 10 device crops. The device is explicit
(``--device``, default ``cuda``; with no card a CUDA run raises). What the
port does not cover yet raises a ``SystemExit`` naming the ROADMAP.md item
it comes with (``cli/unported.py``).
"""

from __future__ import annotations

import argparse
import os
import pickle
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Binary actionness test tool (PyTorch)")
    parser.add_argument("dataset", type=str,
                        choices=["activitynet1.2", "thumos14"])
    parser.add_argument("modality", type=str, choices=["RGB", "Flow", "RGBDiff"])
    parser.add_argument("subset", type=str,
                        choices=["training", "validation", "testing"],
                        help="which proposal list to score: thumos14 "
                             "validation -> train list, testing -> test "
                             "list; activitynet1.2 training -> train list, "
                             "validation -> test list")
    parser.add_argument("weights", type=str)
    parser.add_argument("save_scores", type=str)
    parser.add_argument("--arch", type=str, default="BNInception")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to score on (default cuda); a "
                             "CUDA device with no card is an error")
    parser.add_argument("--frame_interval", type=int, default=5)
    parser.add_argument("--test_batchsize", type=int, default=64,
                        help="frame ticks per device chunk (10 crops each)")
    parser.add_argument("--max_num", type=int, default=-1)
    parser.add_argument("--test_crops", type=int, default=10)
    parser.add_argument("--flow_pref", type=str, default="")
    parser.add_argument("--data_root", default="", type=str)
    parser.add_argument("--prop_file_dir", default="data", type=str)
    parser.add_argument("--synthetic_data", action="store_true")
    parser.add_argument("--int8", action="store_true", default=None,
                        help="int8-quantize the backbone. DEFAULT ON for "
                             "BNInception and InceptionV3; --no_int8 opts "
                             "out")
    parser.add_argument("--no_int8", dest="int8", action="store_false",
                        help="force the float backbone")
    parser.add_argument("--int8_mode", choices=["e2e", "perlayer"],
                        default="e2e",
                        help="e2e: int8 activations end to end (the only "
                             "mode of the port so far)")
    parser.add_argument("--shared_stem", action="store_true", default=None,
                        help="run the stem once per frame+flip and slice the "
                             "10 crop windows on the stride-8 trunk-input "
                             "grid (per-crop scores kept). Default: ON with "
                             "int8-e2e and 10 device crops")
    parser.add_argument("--no_shared_stem", dest="shared_stem",
                        action="store_false",
                        help="force per-crop stem computation")
    parser.add_argument("--gpus", "--devices", dest="devices", nargs="+",
                        type=int, default=None,
                        help="one local device index (multi-device fan-out "
                             "is not in the port yet)")
    parser.add_argument("--host_crops", action="store_true",
                        help="cut the 10-crop oversample on the host (not "
                             "in the port yet)")
    parser.add_argument("--use_reference", action="store_true", default=False,
                        help="score the published ImageNet-init reference "
                             "checkpoint, found in the local model cache "
                             "($ADT_MODEL_CACHE; the weights argument is "
                             "ignored)")
    parser.add_argument("--use_kinetics_reference", action="store_true",
                        default=False,
                        help="as --use_reference, the Kinetics-init model")
    parser.add_argument("-j", "--workers", default=None, type=int,
                        help="host decode threads (default adapts to the "
                             "host core count)")
    # accepted for reference CLI compatibility; unused at test time
    parser.add_argument("--input_size", type=int, default=224,
                        help=argparse.SUPPRESS)
    return parser


def _check_slice(args) -> None:
    """Refuse, by name, what the port does not cover yet."""
    from .unported import CLI_SURFACE, not_yet, refuse_unported_scoring

    if args.host_crops:
        raise not_yet("--host_crops", CLI_SURFACE, "binary_test")
    refuse_unported_scoring(args, "binary_test")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_slice(args)

    from ..models.backbones.quantize import (int8_support_error,
                                             supports_int8,
                                             supports_shared_stem)

    use_int8 = (args.int8 if args.int8 is not None
                else supports_int8(args.arch, args.int8_mode))
    if use_int8 and not supports_int8(args.arch, args.int8_mode):
        raise SystemExit(int8_support_error(args.arch, args.int8_mode))
    if args.int8 is None and not use_int8:
        print(f"int8 off: no int8 path wired for {args.arch}; "
              "running the float backbone", flush=True)
    can_share = (use_int8 and args.int8_mode == "e2e"
                 and supports_shared_stem(args.arch))
    use_shared = (args.shared_stem if args.shared_stem is not None
                  else can_share)
    if use_shared and not can_share:
        raise SystemExit("--shared_stem requires int8-e2e, 10 device crops, "
                         f"and a wired backbone (got arch={args.arch}, "
                         f"int8={use_int8}/{args.int8_mode}, "
                         f"crops={args.test_crops})")

    from ..config import get_actionness_configs
    from ..data.binary_dataset import BinaryDataset
    from ..data.pipeline import (DirectoryFrameProvider,
                                 SyntheticFrameProvider,
                                 collect_calibration_frames)
    from ..infer.actionness import ActionnessScorer
    from ..infer.features import resolve_device
    from ..models import BinaryClassifier
    from ..train import load_checkpoint
    from .opts import scoring_weights

    device = resolve_device(args.device)
    if args.devices and device.type == "cuda":
        device = resolve_device(f"cuda:{args.devices[0]}")
    cfg = get_actionness_configs(args.dataset)

    model = BinaryClassifier(num_class=cfg.num_class, modality=args.modality,
                             base_model=args.arch, dropout=0.0)
    weights = scoring_weights(args)
    ck = load_checkpoint(weights)
    if "classifier_fc.weight" not in ck["state_dict"]:
        # the published reference release ships only SSN detection
        # checkpoints: they have no actionness head
        raise SystemExit(
            f"'{weights}' is not an actionness checkpoint (no "
            "classifier_fc head; it looks like an SSN detection model). "
            "Train one with binary_train.py.")
    model.load_state_dict(ck["state_dict"])
    spec = model.input_spec
    new_length = model.resolved_new_length

    subset_lists = ({"validation": cfg.train_list, "testing": cfg.test_list}
                    if args.dataset == "thumos14" else
                    {"training": cfg.train_list, "validation": cfg.test_list})
    if args.subset not in subset_lists:
        raise SystemExit(f"subset '{args.subset}' is not defined for "
                         f"{args.dataset} (choose from "
                         f"{sorted(subset_lists)})")
    test_prop_file = os.path.join(
        args.prop_file_dir, f"{subset_lists[args.subset]}_proposal_list.txt")
    dataset = BinaryDataset(test_prop_file, new_length=new_length,
                            test_interval=args.frame_interval)

    if args.synthetic_data:
        provider = SyntheticFrameProvider(modality=args.modality)
    else:
        tmpl = ("img_{:05d}.jpg" if args.modality == "RGB"
                else args.flow_pref + "{}_{:05d}.jpg")
        provider = DirectoryFrameProvider(args.data_root, tmpl, args.modality)

    calibration_frames = None
    if use_int8:
        # None (every video empty) leaves the scorer's lazy first-chunk
        # calibration, which then never runs: nothing is scored
        calibration_frames = collect_calibration_frames(
            dataset, provider, spec.input_size, spec.scale_size,
            new_length=new_length)

    n = len(dataset.video_list)
    if args.max_num > 0:
        n = min(n, args.max_num)
    results = {}
    t0 = time.time()
    with ActionnessScorer(model, spec, chunk_frames=args.test_batchsize,
                          modality=args.modality, device=device,
                          quantize=args.int8_mode if use_int8 else False,
                          calibration_frames=calibration_frames,
                          decode_threads=args.workers,
                          shared_stem=use_shared) as scorer:
        for idx in range(n):
            sample = dataset.get_test_sample(idx)
            # keyed by the video-id BASENAME (reference binary_test.py:94):
            # proposal lists carry frame-folder paths, TAG grouping matches
            # scores against dataset-DB ids
            results[sample.video_id.split("/")[-1]] = scorer.score_video(
                sample, provider)
            print(f"video {idx} {sample.video_id} done "
                  f"({(time.time() - t0) / (idx + 1):.3f} sec/video)",
                  flush=True)
    with open(args.save_scores, "wb") as f:
        pickle.dump(results, f, pickle.HIGHEST_PROTOCOL)
    print(f"scores saved to {args.save_scores}")
    return results


if __name__ == "__main__":
    main()
