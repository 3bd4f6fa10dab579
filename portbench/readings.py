"""The readings a scoring cell's limits are set from: for each seed, the
program's numbers (a run's comparison, after a short window), with
``--fault`` those of the program with a fault planted under its timed path
(``portbench/harness/faults.py``), and with ``--control`` the control's
(the reference at the configuration's control precisions in the
program's place, on the same videos), in one process.

    python3 portbench/readings.py --workload <cell> --seconds 1 \\
        --seeds 11 12 13 [--fault half_crops] [--control]

One JSON line a seed on standard output. The benchmark's runs do not run
this.
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=1.0)
    parser.add_argument("--fault", default=None)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.harness.compare import control_gap, sample_videos
    from portbench.harness.faults import FAULTS
    from portbench.harness.registry import job_class, load_cell

    cell = load_cell(ROOT, args.workload)
    if args.fault:
        FAULTS[args.fault](setattr)
    Job = job_class(ROOT, cell.traffic["job"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        workdir = tempfile.mkdtemp(prefix="portbench-")
        try:
            job = Job(cell.config, cell.traffic, seed, args.device, workdir)
            run = job.window(args.seconds)
            job.close()
            checks = job.check(run)
            line = {"workload": args.workload, "seed": seed,
                    "fault": args.fault,
                    **{k: c["value"] for k, c in checks.items()},
                    "calls": len(run.calls)}
            if args.control:
                scored = [(i, v) for i, c in enumerate(run.calls)
                          for v in c.videos if v in c.results]
                vids = sorted({v for _, v in sample_videos(
                    scored, job.traffic, cell.traffic["compare_videos"],
                    seed)})
                line["control_gap"] = control_gap(job, vids)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
