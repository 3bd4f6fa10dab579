"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs on the card of the machine it starts on, from the root of a
checkout; the last line of standard output is the result object, and the
numbers compared with the reference, each beside its limit, are the last
lines of standard error. Without a card, or with fewer than the cell asks
for, it prints no result and exits with 2; where JAX or the JAX package
got loaded into the process, with 3.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: top-level modules that must not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "action_detection_tpu")


def loaded_forbidden() -> list:
    """The forbidden top-level module names that ``sys.modules`` holds,
    each compared whole (the part before the first dot)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, ROOT)
    from portbench.harness.registry import load_cell

    cell = load_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.harness.execute import execute, print_result

    result = execute(ROOT, cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", START)
    found = loaded_forbidden()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 3
    print_result(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
