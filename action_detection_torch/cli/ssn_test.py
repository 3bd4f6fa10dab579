"""SSN proposal-scoring CLI (torch port of ``action_detection_tpu/cli/ssn_test.py``).

Usage: python -m action_detection_torch.cli.ssn_test <dataset> <modality>
       <weights> <save_scores> [flags]

``weights`` is a port ``.pt``, a JAX ``checkpoint.msgpack`` or a reference
``.pth``/``.pth.tar`` (``train/checkpoint.py:load_checkpoint``);
``--use_reference`` / ``--use_kinetics_reference`` score the published
reference checkpoint from the local model cache (``$ADT_MODEL_CACHE``) in
its place. Every backbone of the JAX registry scores; ResNet and VGG have
no int8 path and score in float32.

Same flags and defaults logic as the JAX CLI: int8 end to end with the
shared stem is the default for BNInception and InceptionV3, for RGB, Flow
(``new_length`` 5: 10-channel x/y stacks, frames read from
``<flow_pref>{x,y}_NNNNN.jpg``) and RGBDiff (``new_length`` 5: the
differences of 6 RGB frames, ``img_NNNNN.jpg``); ``--int8_mode perlayer``
(BNInception) quantizes each conv's bf16 input instead; ``--test_crops 1``
scores one center crop cut on the host. The device is explicit
(``--device``, default ``cuda``); with no card, a CUDA run raises instead of
continuing on the CPU. ``--gpus``/``--devices`` fan the videos out over
several GPUs (default: every local GPU under ``--device cuda``), one thread
and one scorer each (``infer/scorer.py:score_videos``); the int8 tree is
calibrated once and shared, and the decode pool (``-j``) is one for all.
``--pack`` (default on a host of 4 or more cores, as in the JAX CLI;
``--no_pack`` turns it off) packs ticks of several videos into each chunk
(``ProposalScorer.score_video_pack``): the same scores, less padding.
"""

from __future__ import annotations

import argparse
import os
import time


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="SSN Testing Tool (PyTorch)")
    parser.add_argument("dataset", type=str, choices=["activitynet1.2", "thumos14"])
    parser.add_argument("modality", type=str, choices=["RGB", "Flow", "RGBDiff"])
    parser.add_argument("weights", type=str)
    parser.add_argument("save_scores", type=str)
    parser.add_argument("--arch", type=str, default="BNInception")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to score on (default cuda); a "
                             "CUDA device with no card is an error")
    parser.add_argument("--save_raw_scores", type=str, default=None)
    parser.add_argument("--frame_interval", type=int, default=6)
    parser.add_argument("--test_batchsize", type=int, default=64,
                        help="frame ticks per device chunk")
    parser.add_argument("--no_regression", action="store_true", default=False)
    parser.add_argument("--max_num", type=int, default=-1)
    parser.add_argument("--test_crops", type=int, default=10)
    parser.add_argument("--flow_pref", type=str, default="")
    parser.add_argument("--data_root", default="", type=str)
    parser.add_argument("--prop_file_dir", default="data", type=str)
    parser.add_argument("--synthetic_data", action="store_true")
    parser.add_argument("--int8", action="store_true", default=None,
                        help="int8-quantize the backbone, activation scales "
                             "calibrated across test videos. DEFAULT ON for "
                             "BNInception and InceptionV3; --no_int8 opts out")
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
                             "grid. Default: ON with int8-e2e and 10 crops")
    parser.add_argument("--no_shared_stem", dest="shared_stem",
                        action="store_false",
                        help="force per-crop stem computation")
    parser.add_argument("--gpus", "--devices", dest="devices", nargs="+",
                        type=int, default=None,
                        help="local GPU indices to fan the videos out over "
                             "(default: every local GPU under --device "
                             "cuda)")
    parser.add_argument("--pack", action="store_true", default=None,
                        help="cross-video tick packing: the same scores "
                             "with less chunk padding. Default: on when "
                             "the host has 4 or more cores")
    parser.add_argument("--no_pack", dest="pack", action="store_false",
                        help="score each video in chunks of its own")
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
    parser.add_argument("--aug_ratio", type=float, default=0.5,
                        help=argparse.SUPPRESS)
    parser.add_argument("--input_size", type=int, default=224,
                        help=argparse.SUPPRESS)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from ..models.backbones.quantize import supports_shared_stem
    from .opts import scoring_int8, scoring_weights

    use_int8 = scoring_int8(args)

    use_shared = (args.shared_stem if args.shared_stem is not None
                  else (use_int8 and args.int8_mode == "e2e"
                        and args.test_crops == 10
                        and supports_shared_stem(args.arch)))
    if use_shared and not (use_int8 and args.int8_mode == "e2e"
                           and args.test_crops == 10
                           and supports_shared_stem(args.arch)):
        raise SystemExit("--shared_stem requires int8-e2e, 10 test crops, "
                         f"and a wired backbone (got arch={args.arch}, "
                         f"int8={use_int8}/{args.int8_mode}, "
                         f"crops={args.test_crops})")

    from ..config import get_configs
    from ..data.pipeline import (DirectoryFrameProvider,
                                 SyntheticFrameProvider,
                                 collect_calibration_frames, frame_template,
                                 make_test_transform)
    from ..data.pipeline import make_decode_pool
    from ..data.ssn_dataset import SSNDataset
    from ..infer.features import shared_prequantized
    from ..infer.scorer import (ProposalScorer, dump_scores_pickle,
                                score_videos)
    from ..models import SSN
    from ..parallel import cli_devices
    from ..train import load_checkpoint

    devices = cli_devices(args.device, args.devices)
    cfg = get_configs(args.dataset)

    model = SSN(num_class=cfg.num_class, modality=args.modality,
                base_model=args.arch, dropout=0.0,
                with_regression=not args.no_regression, stpp_cfg=cfg.stpp)
    spec = model.input_spec
    # raises on a crop count other than 1 or 10, as the JAX CLI does
    transform = make_test_transform(spec.input_size, spec.scale_size,
                                    args.test_crops)
    ck = load_checkpoint(scoring_weights(args))
    model.load_state_dict(ck["state_dict"])
    reg_stats = ck.get("reg_stats")

    test_prop_file = os.path.join(args.prop_file_dir,
                                  f"{cfg.test_list}_proposal_list.txt")
    dataset = SSNDataset(test_prop_file, cfg.sampling,
                         new_length=model.resolved_new_length,
                         test_interval=args.frame_interval)

    if args.synthetic_data:
        provider = SyntheticFrameProvider(modality=args.modality)
    else:
        provider = DirectoryFrameProvider(
            args.data_root, frame_template(args.modality, args.flow_pref),
            args.modality)

    calibration_frames = None
    if use_int8:
        # None (every sampled video empty) falls back to the scorer's lazy
        # first-chunk calibration
        calibration_frames = collect_calibration_frames(
            dataset, provider, transform,
            new_length=model.resolved_new_length)

    # one decode pool for every device's scorer: -j threads in all
    decode_pool = make_decode_pool(args.workers)
    scorers = []

    def make_scorer(dev, prequantized):
        scorer = ProposalScorer(
            model, spec, reg_stats=reg_stats, num_class=cfg.num_class,
            stpp_cfg=cfg.stpp, test_crops=args.test_crops,
            chunk_frames=args.test_batchsize, modality=args.modality,
            device=dev, with_regression=not args.no_regression,
            quantize=args.int8_mode if use_int8 else False,
            calibration_frames=calibration_frames, shared_stem=use_shared,
            prequantized=prequantized, decode_pool=decode_pool)
        scorers.append(scorer)
        return scorer

    # the pack default adapts to the host, as the JAX CLI's: its
    # continuous decode-ahead starves the consumer of a host of few cores
    use_pack = (args.pack if args.pack is not None
                else (os.cpu_count() or 1) >= 4)
    n = len(dataset.video_list)
    if args.max_num > 0:
        n = min(n, args.max_num)
    t0 = time.time()
    try:
        results = score_videos(shared_prequantized(make_scorer, use_int8),
                               dataset, provider, indices=range(n),
                               devices=devices,
                               keep_raw=args.save_raw_scores is not None,
                               progress=True, pack=use_pack)
    finally:
        if decode_pool is not None:
            decode_pool.shutdown(wait=False)
    dt = time.time() - t0
    where = ", ".join(str(d) for d in devices)
    print(f"scored {len(results)} videos in {dt:.1f}s "
          f"({dt / max(len(results), 1):.3f} sec/video) on {where}"
          f"{' (packed)' if use_pack else ''}; "
          f"{sum(s.device_ticks for s in scorers)} ticks scored on the "
          f"device for {sum(s.real_ticks for s in scorers)} frame ticks")
    dump_scores_pickle(results, args.save_scores,
                       raw_path=args.save_raw_scores)
    print(f"scores saved to {args.save_scores}")
    return results


if __name__ == "__main__":
    main()
