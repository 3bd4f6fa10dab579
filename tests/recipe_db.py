"""A dataset for the reproduction recipes (``scripts/reproduce_*.sh`` and
their twins in ``action_detection_torch/scripts``), and the ``python``
shim that runs them small: used by ``tests/test_torch_port_recipes.py``
and ``chip_smoke.py``. Imports no PIL and no JAX (torch only inside
:func:`write_flow_init`).

:func:`write_recipe_db` lays out what the recipes read: the normalized
TAG proposal lists under ``<workdir>/data`` (the train and test lists of
THUMOS14 or ActivityNet v1.2, each video with two ground-truth instances
and foreground, incomplete and background proposals, as fractions of the
video) and frame directories whose ``img_``, ``x_`` and ``y_`` files link,
in turn, to the committed 340x256 JPEG frames.
:func:`write_python_shim` writes a ``python`` that appends flags to each
CLI the recipes call (argparse takes the last occurrence of a flag, so
the recipes gain no knob) and prints one ``RECIPE-STEP`` JSON line a step:
the CLI, its wall and, for the port's CLIs, their launch counts.
"""

from __future__ import annotations

import os
import stat
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port_jpeg")
N_FIXTURE_FRAMES = 8
#: dataset -> (train list, test list, the ids of their videos, classes)
DATASETS = {
    "thumos14": ("thumos14_tag_val", "thumos14_tag_test",
                 lambda split, i: (f"video_{split}_{i:07d}",) * 2, 20),
    # ActivityNet folders are v_<id>; the lists key them by the 11-char id
    "activitynet1.2": ("activitynet1.2_tag_train", "activitynet1.2_tag_val",
                       lambda split, i: (f"v_{split[:3]}{i:08d}",
                                         f"{split[:3]}{i:08d}"), 100),
}


def link_frames(frames_root: str, folder: str, n: int) -> None:
    """``frames_root/folder`` with ``img_``, ``x_`` and ``y_`` frames
    1..n, links cycling over the committed JPEG frames."""
    d = os.path.join(frames_root, folder)
    os.makedirs(d)
    for i in range(1, n + 1):
        k = (i - 1) % N_FIXTURE_FRAMES + 1
        for src, dst in ((f"img_{k:05d}.jpg", f"img_{i:05d}.jpg"),
                         (f"x_{k:05d}.jpg", f"x_{i:05d}.jpg"),
                         (f"y_{k:05d}.jpg", f"y_{i:05d}.jpg")):
            os.symlink(os.path.join(JPEG_FIXTURES, src),
                       os.path.join(d, dst))


def _normalized_group(index: int, vid: str, classes: int,
                      rng: np.random.RandomState) -> str:
    """One video of a normalized list (coordinates as fractions), its two
    instances of classes 1..``classes``."""
    labels = 1 + rng.choice(classes, 2, replace=False)
    gt = [(labels[0], 0.15, 0.45), (labels[1], 0.6, 0.85)]
    props = []
    for c, s, e in gt:
        d = e - s
        props += [(c, 0.85, 0.9, s - 0.03, e + 0.01),
                  (c, 0.75, 0.95, s + 0.01, e - 0.02),
                  (c, 0.2, 0.9, s + 0.05, s + 0.05 + 0.4 * d),
                  (c, 0.15, 0.85, s + 0.08, s + 0.08 + 0.4 * d)]
    props += [(0, 0.0, 0.0, 0.88, 0.99), (0, 0.005, 0.0, 0.01, 0.12)]
    lines = [f"# {index}\n{vid}\n1\n1\n{len(gt)}\n"]
    lines += [f"{c} {s:.4f} {e:.4f}\n" for c, s, e in gt]
    lines.append(f"{len(props)}\n")
    lines += [f"{c} {iou:.4f} {ov:.4f} {s:.4f} {e:.4f}\n"
              for c, iou, ov, s, e in props]
    return "".join(lines)


def write_recipe_db(workdir: str, frames_root: str, dataset: str,
                    train_videos: int = 2, test_videos: int = 2,
                    frames: int = 300, seed: int = 0,
                    classes: int = 0) -> None:
    """``workdir/data/<list>_normalized_proposal_list.txt`` for the
    dataset's train and test lists (ground truth of classes 1..``classes``,
    all the dataset's by default), and ``frames_root/<folder>`` frame
    directories of ``frames`` frames for each of their videos (made once:
    a second workdir over the same frames passes an existing
    ``frames_root``)."""
    train, test, ids, num_class = DATASETS[dataset]
    classes = classes or num_class
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(workdir, "data"), exist_ok=True)
    make_frames = not os.path.isdir(frames_root)
    for name, split, n in ((train, "validation" if dataset == "thumos14"
                            else "training", train_videos),
                           (test, "test" if dataset == "thumos14"
                            else "validation", test_videos)):
        groups = []
        for i in range(1, n + 1):
            folder, vid = ids(split, i)
            groups.append(_normalized_group(i - 1, vid, classes, rng))
            if make_frames:
                link_frames(frames_root, folder, frames)
        with open(os.path.join(workdir, "data",
                               f"{name}_normalized_proposal_list.txt"),
                  "w") as f:
            f.writelines(groups)


def write_flow_init(path: str, arch: str, seed: int = 2) -> None:
    """A seeded RGB backbone of ``arch`` (the port's ``seeded_init``) as a
    reference ``.pth``: DataParallel ``module.base_model.`` keys, no
    ``num_batches_tracked`` (imports torch and the port)."""
    import torch

    from action_detection_torch.models import SSN, seeded_init

    sd = seeded_init(SSN(num_class=20, base_model=arch),
                     seed=seed).state_dict()
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()
                               if k.startswith("base_model.")
                               and not k.endswith("num_batches_tracked")}},
               path)


SHIM = '''#!{python}
"""The recipes' python: each CLI with its EXTRA flags appended, one
RECIPE-STEP line a step."""
import json, os, runpy, sys, time

EXTRA = {extra!r}
RENAME = {rename!r}
args = sys.argv[1:]
port = args[:1] == ["-m"]
cli = (args[1].rsplit(".", 1)[-1] if port
       else os.path.basename(args[0])[:-len(".py")])
rest = args[2:] if port else args[1:]
# a checkpoint the recipe names under its architecture, read under the
# one the shim trains
rest = [a.replace(*RENAME) if cli == "ssn_test" and RENAME else a
        for a in rest]
side = "port" if port else "jax"
modality = rest[1] if len(rest) > 1 else ""
extra = EXTRA.get((side, cli), []) + EXTRA.get((side, cli, modality), [])
if not port:
    os.execv(sys.executable, [sys.executable, args[0]] + rest + extra)
sys.argv = [args[1]] + rest + extra
t0 = time.perf_counter()
try:
    runpy.run_module(args[1], run_name="__main__", alter_sys=True)
finally:
    step = {{"cli": cli, "argv": sys.argv[1:],
             "wall_s": time.perf_counter() - t0}}
    if "torch" in sys.modules:
        from action_detection_torch.kernels import launch_counts
        step["launches"] = launch_counts()
    print("RECIPE-STEP " + json.dumps(step), flush=True)
'''


def write_python_shim(bin_dir: str, extra: dict, rename=None,
                      python: str = sys.executable) -> str:
    """``bin_dir/python``: runs ``python -m <cli>`` (the port) in process
    with ``extra[("port", cli)]`` appended, and ``python <cli>.py`` (the
    JAX launchers) with ``extra[("jax", cli)]``, each followed by the
    entry of ``(side, cli, modality)`` (the CLI's second argument) where
    there is one; ``rename`` (old, new)
    rewrites the checkpoint names ``ssn_test`` is given (the recipes name
    BNInception's). Put ``bin_dir`` first on ``PATH``."""
    os.makedirs(bin_dir, exist_ok=True)
    path = os.path.join(bin_dir, "python")
    with open(path, "w") as f:
        f.write(SHIM.format(python=python, extra=extra, rename=rename))
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return path


def recipe_steps(output: str) -> list:
    """The RECIPE-STEP records of a recipe's output, in order."""
    import json

    return [json.loads(line.split(" ", 1)[1]) for line in output.splitlines()
            if line.startswith("RECIPE-STEP ")]


def map_row(output: str) -> list:
    """The mean-AP row of the last mAP table in an output: one value an
    IoU threshold, then their average."""
    rows = [line for line in output.splitlines() if "mean AP" in line]
    return [float(c) for c in rows[-1].strip("|").split("|")[1:]]
