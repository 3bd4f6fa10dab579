"""Refusal, by name, of what the port's CLIs do not cover yet.

Each refusal names the ROADMAP.md queue 1 item that brings it (by that
item's heading) and the JAX CLI that has it already.
"""

from __future__ import annotations

#: ROADMAP.md queue 1 headings of the slices the refusals point to
HOST_THROUGHPUT = "ssn_test host throughput"
DATA_PARALLEL = "Data parallel"


def not_yet(what: str, slice_: str, cli: str) -> SystemExit:
    return SystemExit(f"{what} is not in the PyTorch port yet: it comes with "
                      f"ROADMAP.md queue 1, '{slice_}'. The JAX CLI "
                      f"(action_detection_tpu.cli.{cli}) has it.")


def refuse_unported_scoring(args, cli: str) -> None:
    """The refusals ``ssn_test`` and ``binary_test`` share."""
    if args.devices is not None and len(args.devices) > 1:
        raise not_yet("scoring on several devices", DATA_PARALLEL, cli)


def refuse_unported_training(args, cli: str) -> None:
    """The refusals ``ssn_train`` and ``binary_train`` share."""
    if args.devices is not None and len(args.devices) > 1:
        raise not_yet("training on several devices", DATA_PARALLEL, cli)
    if (args.coordinator_address is not None
            or args.num_processes is not None
            or args.process_id is not None):
        raise not_yet("multi-host training (--coordinator_address, "
                      "--num_processes, --process_id)", DATA_PARALLEL, cli)
