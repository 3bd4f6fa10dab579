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
BNInception and InceptionV3, 10 device crops; ``--int8_mode perlayer``
(BNInception), RGB, Flow and RGBDiff, and host crops (``--host_crops``, or
``--test_crops 1``). The device is explicit
(``--device``, default ``cuda``; with no card a CUDA run raises).
``--gpus``/``--devices`` score over several GPUs (default: every local GPU
under ``--device cuda``): one thread and one scorer per device pulling
videos from one queue (``infer/actionness.py:score_actionness``), the
calibrated int8 tree computed once and placed on each device, one decode
pool (``-j``) for all.
"""

from __future__ import annotations

import argparse
import os
import pickle


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
                        help="frame ticks per device chunk")
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
                        help="e2e: int8 activations end to end (default); "
                             "perlayer: bf16 activations quantized at each "
                             "conv (BNInception)")
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
                        help="local GPU indices to score the videos on "
                             "(default: every local GPU under --device "
                             "cuda)")
    parser.add_argument("--host_crops", action="store_true",
                        help="cut the 10-crop oversample on the host instead "
                             "of on the device (debugging, parity checks)")
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


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..models.backbones.quantize import supports_shared_stem
    from .opts import scoring_int8, scoring_weights

    use_int8 = scoring_int8(args)
    use_device_crops = args.test_crops == 10 and not args.host_crops
    can_share = (use_device_crops and use_int8 and args.int8_mode == "e2e"
                 and supports_shared_stem(args.arch))
    use_shared = (args.shared_stem if args.shared_stem is not None
                  else can_share)
    if use_shared and not can_share:
        raise SystemExit("--shared_stem requires int8-e2e, 10 device crops, "
                         f"and a wired backbone (got arch={args.arch}, "
                         f"int8={use_int8}/{args.int8_mode}, "
                         f"crops={args.test_crops}, "
                         f"host_crops={args.host_crops})")

    from ..config import get_actionness_configs
    from ..data.binary_dataset import BinaryDataset
    from ..data.pipeline import (DirectoryFrameProvider,
                                 SyntheticFrameProvider,
                                 collect_calibration_frames, frame_template,
                                 make_decode_pool, make_test_transform)
    from ..infer.actionness import ActionnessScorer, score_actionness
    from ..infer.features import shared_prequantized
    from ..models import BinaryClassifier
    from ..parallel import cli_devices
    from ..train import load_checkpoint

    devices = cli_devices(args.device, args.devices)
    cfg = get_actionness_configs(args.dataset)

    model = BinaryClassifier(num_class=cfg.num_class, modality=args.modality,
                             base_model=args.arch, dropout=0.0)
    spec = model.input_spec
    new_length = model.resolved_new_length
    # raises on a crop count other than 1 or 10, as the JAX CLI does
    transform = make_test_transform(spec.input_size, spec.scale_size,
                                    args.test_crops)
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
        provider = DirectoryFrameProvider(
            args.data_root, frame_template(args.modality, args.flow_pref),
            args.modality)

    calibration_frames = None
    if use_int8:
        # None (every video empty) leaves the scorer's lazy first-chunk
        # calibration, which then never runs: nothing is scored
        calibration_frames = collect_calibration_frames(
            dataset, provider, transform, new_length=new_length)

    n = len(dataset.video_list)
    if args.max_num > 0:
        n = min(n, args.max_num)
    decode_pool = make_decode_pool(args.workers) if use_device_crops else None

    def make_scorer(dev, prequantized):
        return ActionnessScorer(
            model, spec, test_crops=args.test_crops,
            chunk_frames=args.test_batchsize, modality=args.modality,
            device=dev, quantize=args.int8_mode if use_int8 else False,
            calibration_frames=calibration_frames,
            device_crops=use_device_crops, shared_stem=use_shared,
            prequantized=prequantized, decode_pool=decode_pool)

    try:
        results = score_actionness(shared_prequantized(make_scorer, use_int8),
                                   dataset, provider, indices=range(n),
                                   devices=devices, progress=True)
    finally:
        if decode_pool is not None:
            decode_pool.shutdown(wait=False)
    with open(args.save_scores, "wb") as f:
        pickle.dump(results, f, pickle.HIGHEST_PROTOCOL)
    print(f"scores saved to {args.save_scores}")
    return results


if __name__ == "__main__":
    main()
