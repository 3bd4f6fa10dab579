"""The training CLIs' flags (port of ``action_detection_tpu/cli/opts.py``),
and the scoring CLIs' weights file and int8 choice.

The JAX CLIs' flags and defaults, plus ``--device``.
"""

from __future__ import annotations

import argparse


def scoring_weights(args) -> str:
    """The checkpoint ``ssn_test``/``binary_test`` score: ``args.weights``,
    or with ``--use_reference``/``--use_kinetics_reference`` the published
    reference checkpoint in the local model cache (raises
    ``FileNotFoundError`` naming the path when it is not there)."""
    if not (args.use_reference or args.use_kinetics_reference):
        return args.weights
    from ..config import resolve_reference_checkpoint

    path = resolve_reference_checkpoint(
        args.dataset, args.modality,
        "ImageNet" if args.use_reference else "Kinetics", args.arch)
    print(f"using reference model: {path}", flush=True)
    return path


def scoring_int8(args) -> bool:
    """Whether ``ssn_test``/``binary_test`` score on an int8 backbone, by
    the JAX CLIs' rule: ``--int8``/``--no_int8`` where given, else int8
    wherever ``--int8_mode`` is wired for ``--arch``. An int8 mode the arch
    lacks exits, when asked for by ``--int8`` or by a mode other than the
    default ``e2e``; a float run without int8 says so."""
    from ..models.backbones.quantize import int8_support_error, supports_int8

    use_int8 = (args.int8 if args.int8 is not None
                else supports_int8(args.arch, args.int8_mode))
    if use_int8 and not supports_int8(args.arch, args.int8_mode):
        raise SystemExit(int8_support_error(args.arch, args.int8_mode))
    if args.int8 is None and not use_int8:
        if args.int8_mode != "e2e":
            # an explicitly asked quantized mode never runs as float
            raise SystemExit(
                int8_support_error(args.arch, args.int8_mode)
                + "; pass --no_int8 to run the float backbone")
        print(f"int8 off: no int8 path wired for {args.arch}; "
              "running the float backbone", flush=True)
    return use_int8


def build_train_parser(description: str) -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("dataset", type=str,
                        choices=["activitynet1.2", "thumos14"])
    parser.add_argument("modality", type=str, choices=["RGB", "Flow", "RGBDiff"])

    # model
    parser.add_argument("--arch", type=str, default="BNInception")
    parser.add_argument("--num_aug_segments", type=int, default=2)
    parser.add_argument("--num_body_segments", type=int, default=5)
    parser.add_argument("--dropout", "--do", default=0.8, type=float)

    # learning
    parser.add_argument("--epochs", default=7, type=int)
    parser.add_argument("--training_epoch_multiplier", "--tem", default=10,
                        type=int)
    parser.add_argument("-b", "--batch-size", default=16, type=int)
    parser.add_argument("-i", "--iter-size", "--iter_size", default=1,
                        type=int)
    parser.add_argument("--lr", "--learning-rate", default=0.001, type=float)
    parser.add_argument("--lr_steps", default=[3, 6], type=float, nargs="+")
    parser.add_argument("--momentum", default=0.9, type=float)
    parser.add_argument("--weight-decay", "--wd", default=5e-4, type=float)
    parser.add_argument("--clip-gradient", "--gd", default=None, type=float)
    parser.add_argument("--bn_mode", "--bn", default="frozen", type=str,
                        choices=["frozen", "partial", "full"])
    parser.add_argument("--comp_loss_weight", "--lw", default=0.1, type=float)
    parser.add_argument("--reg_loss_weight", "--rw", default=0.1, type=float)

    # monitoring
    parser.add_argument("--print-freq", "-p", default=20, type=int)
    parser.add_argument("--eval-freq", "-ef", default=1, type=int)

    # runtime
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to train on (default cuda); a "
                             "CUDA device with no card is an error")
    parser.add_argument("-j", "--workers", default=4, type=int,
                        help="host threads assembling batches")
    parser.add_argument("--gpus", "--devices", dest="devices", nargs="+",
                        type=int, default=None,
                        help="local GPU indices, one training rank each "
                             "(default: every local GPU under --device "
                             "cuda)")
    parser.add_argument("--resume", default="", type=str)
    parser.add_argument("--kinetics_pretrain", "--kin", default=False,
                        action="store_true")
    parser.add_argument("--init_weights", default="", type=str)
    parser.add_argument("-e", "--evaluate", dest="evaluate",
                        action="store_true")
    parser.add_argument("--snapshot_pref", type=str, default="")
    parser.add_argument("--start-epoch", default=0, type=int)
    parser.add_argument("--flow_prefix", default="", type=str)
    parser.add_argument("--data_root", default="", type=str,
                        help="root directory of extracted frames")
    parser.add_argument("--prop_file_dir", default="data", type=str,
                        help="directory holding <list>_proposal_list.txt "
                             "files")
    parser.add_argument("--synthetic_data", action="store_true",
                        help="use the synthetic frame provider (smoke tests)")
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--trace_dir", default=None, type=str,
                        help="write a torch.profiler trace of one "
                             "steady-state train step")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 backbone compute (params stay f32)")
    parser.add_argument("--remat", action="store_true",
                        help="recompute backbone activations in the "
                             "backward pass, stage by stage (larger batches "
                             "per card)")
    # multi-host data-parallel training: every process of the job passes
    # all three (rank 0 of process 0 listens at the coordinator)
    parser.add_argument("--coordinator_address", default=None, type=str,
                        help="host:port of the job's process group")
    parser.add_argument("--num_processes", default=None, type=int,
                        help="processes in the job (one per host)")
    parser.add_argument("--process_id", default=None, type=int,
                        help="this process's index in the job")
    return parser
