"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero
before the final line):

1. device   — the card's name and power limit (nvidia-smi), torch and CUDA
              versions. No CUDA device: exit 1.
2. build    — nvcc builds the kernels K1-K3 and A1 from
              ``action_detection_torch/csrc`` into
              ``action_detection_torch/_build``.
3. kernels  — K1 (int8 conv, both epilogues), K2 (int8 max pool, both
              variants) and K3 (int8 avg pool) at the BNInception scoring
              shapes (640 crops; K2 at 3c, 4e and 5b); K1 with per-axis
              pads (5x5, 1x7, 7x1, 1x3, VALID 3x3 s2, a fused entry conv
              and a conv on its channel slice), K2 without padding and K3's
              exclude-pad mode at InceptionV3's 640-crop shapes; K1 at tile
              tails (rows, columns and depth not multiples of the tile) and
              K2 at grids no tile divides, with signed inputs (K2's with
              -128 and all-negative windows at the padded edges); and A1
              (max-pool backward) at every BNInception max pool of the
              training step (1,152 images). Each is held EXACTLY equal to
              its plain torch version on the same inputs; median ms of
              both, the bound (``work``: the larger of the bytes over 3.35
              TB/s and the operations over the peak of their type) and,
              where one PyTorch call computes the same function, that
              call's ms (``torch._int_mm`` for K1's 1x1 shapes: the GEMM
              without the epilogue; torch's max-pool backward for A1;
              ``F.max_pool2d`` on the channels-last view for K2, where
              torch's CUDA max pool takes int8). A1 also launches twice on
              the same inputs (equal bits).
4. main     — four paths, each with the launch counts set to 0 just before
              it and read just after, each required to launch its kernels:
              the port's ``ssn_test`` CLI in-process at full width with the
              int8-e2e shared-stem default and seeded random weights, on 2
              synthetic videos of 1,560 frames each, for BNInception RGB
              (THUMOS14, 224^2), InceptionV3 RGB (ActivityNet v1.2, K=100,
              340x256 frames resized to 452x341 on the host, 299^2 crops;
              K3 in its exclude-pad mode) and BNInception Flow (THUMOS14,
              new_length 5: 10-channel stacks); and SSN training steps at
              full width (BNInception 224^2, 16 videos x 8 proposals x 9
              segments = 1,152 images per step, frozen BN, dropout 0.8)
              through ``make_train_step``. Each score pickle is checked for
              shapes and finite values, the training metrics for finite
              values.
5. checks   — for BNInception and InceptionV3: the int8 trunk held
              bit-exact against the plain kernels on the CPU, the int8
              features against the float backbone (cos > 0.99, rel <
              0.12); a small train step on the card against the same step
              on the CPU; the host's decode + resize time of a 64-tick
              InceptionV3 chunk; and the steady-state times of one 640-crop
              scoring step (BNInception int8 and float, InceptionV3 int8 and
              float, BNInception and InceptionV3 Flow) and of one training
              step.

``python3 chip_smoke.py --kernels-of CHECKOUT`` runs phase 3 alone on the
kernels of another checkout (e.g. a ``git archive`` of an earlier commit),
so two versions' kernels are timed by the same method on one card.

``python3 chip_smoke.py --profile DIR`` adds a torch.profiler phase: the
per-kernel device time and the device busy share of the scoring steps
(BNInception, InceptionV3, Flow), a training step and the whole ``ssn_test``
runs of BNInception and InceptionV3, with the full tables written to
``DIR/profile_*.txt``.

The second-to-last lines are a JSON summary of the kernels and the
nvidia-smi line; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import pickle
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SLICE_N = 640     # 64 ticks x 10 crops: one scoring step
TRAIN_VIDEOS = 16     # -b 16, the training CLI's default batch
TRAIN_N = TRAIN_VIDEOS * 8 * 9   # x 8 proposals x 9 segments = 1,152 images
TRAIN_STEPS = 4
HBM_GBS = 3350.0    # the H100 SXM's HBM3 bandwidth, GB/s (NVIDIA data sheet)
INT8_OPS = 1979e12  # dense int8 tensor-core peak, ops/s (NVIDIA data sheet)
CORE_OPS = 67e12    # float32 peak outside the tensor cores, ops/s (the same)
TPU_SRC = "action_detection_tpu/models/backbones/bn_inception_int8.py"
IV3_SRC = "action_detection_tpu/models/backbones/inception_v3_int8.py"
REG_STATS = [[0.01, -0.02], [0.1, 0.2]]    # the checkpoints' reg_stats


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_kernel_ms(fn, reps: int, graph: bool = True) -> float:
    """Device time of one ``fn()`` in ms: CUDA events around ``reps`` calls
    divided by ``reps``, the median of three such runs after a warm-up.
    With ``graph`` the calls are captured once in a CUDA graph and the
    graph is replayed, so the wrappers' host work (tens of us a call, more
    than a small kernel's device time) is not counted; without, the calls
    are launched back to back (for the plain versions, whose ops are not
    all capturable)."""
    import torch

    fn()
    torch.cuda.synchronize()
    calls, run = reps, fn
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        run, reps = g.replay, 1
    runs = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            run()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / calls)
    return statistics.median(runs)


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn()`` in ms (CUDA events around each call,
    synchronized: a scoring step as the CLI runs it)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def work(nbytes: float, ops: float, peak: float) -> tuple:
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``nbytes`` moved across HBM once and ``ops`` operations at ``peak``."""
    t_bytes = nbytes / (HBM_GBS * 1e9) * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv_work(x, w, out) -> tuple:
    """K1's bound: x (its channels only, for a slice), w, scale and bias
    read once, ``out`` written once; 2 ops per MAC at the int8 peak."""
    O, kh, kw, C = w.shape
    nbytes = x.numel() + w.numel() + 8 * O + out.numel() * out.element_size()
    return work(nbytes, 2 * out.numel() * kh * kw * C, INT8_OPS)


def pool_work(x, out, k: int) -> tuple:
    """A pool's bound: x read once, ``out`` written once; k*k window cells
    an output value at the float32 peak outside the tensor cores."""
    return work((x.numel() + out.numel()) * x.element_size(),
                out.numel() * k * k, CORE_OPS)


def check_kernels(card: str) -> list:
    """Phase 3: K1-K3 against their plain versions at the slice's shapes."""
    import torch

    from action_detection_torch.kernels import int8 as k
    from action_detection_torch.kernels import pool_bwd as a1
    from action_detection_torch.models.backbones.bn_inception import pool_pads
    from action_detection_torch.ops.pooling import _reduce_max

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def act(*shape, lo=0):   # post-ReLU int8 activations, or signed
        return torch.randint(lo, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def weights(O, kh, kw, C):
        return torch.randint(-127, 128, (O, kh, kw, C), generator=g,
                             device=dev, dtype=torch.int8)

    rows = {"int8_conv": [], "int8_conv/per_axis_pad": [],
            "int8_max_pool": [], "int8_max_pool/valid": [],
            "int8_avg_pool": [], "int8_avg_pool/exclude_pad": [],
            "max_pool_bwd": []}

    def record(name, label, got, ref, fn, plain, bound, library=None):
        """Check ``got == ref``; time the kernel, its plain version and the
        library call (``plain`` itself where the plain version is one);
        ``bound`` is ``work(...)``'s pair."""
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}[{label}] differs from its plain "
                                 f"version: max |diff| {err}")
        ms = _time_kernel_ms(fn, reps=10)
        plain_ms = _time_kernel_ms(plain, reps=2, graph=False)
        lib_ms = (plain_ms if library is plain else
                  _time_kernel_ms(library, reps=10) if library else None)
        bound_ms, bound_by = bound
        rows[name].append(dict(label=label, err=err, ms=ms,
                               plain_ms=plain_ms, bound_ms=bound_ms,
                               bound_by=bound_by, library_ms=lib_ms))
        lib = "" if lib_ms is None else f", library {lib_ms:.3f} ms"
        print(f"kernel {name}[{label}]: equal, max|d|={err} {ms:.3f} ms "
              f"(plain {plain_ms:.3f} ms{lib}); bound {bound_ms:.3f} ms "
              f"({bound_by}) = {bound_ms / ms:.1%} of the bound on {card}",
              flush=True)

    def edge_input(*shape):
        """Signed int8 with -128 in it; the last rows and columns negative
        and windows of -128 alone at the bottom-right (padded) corner."""
        x = act(*shape, lo=-128)
        neg = torch.randint(-128, 0, shape, generator=g, device=dev,
                            dtype=torch.int8)
        x[:, -3:] = neg[:, -3:]
        x[:, :, -3:] = neg[:, :, -3:]
        x[:, -3:, -3:, ::2] = -128
        return x

    library_refusal = []

    def max_pool_library(x, stride, pads, ref):
        """torch's own max pool on the NHWC tensor viewed as channels-last
        NCHW (ceil_mode for Caffe-ceil pads), checked equal to ``ref``; None
        where torch's CUDA max pool refuses int8 (its error printed once)."""
        (t, b), (l, r) = pads
        xv = x.permute(0, 3, 1, 2)

        def library():
            return torch.nn.functional.max_pool2d(
                xv, 3, stride, t, ceil_mode=b > t or r > l)
        try:
            y = library()
        except (RuntimeError, NotImplementedError) as e:
            if not library_refusal:
                library_refusal.append(e)
                print(f"library: torch's CUDA max_pool2d on int8: "
                      f"{type(e).__name__}: {str(e).splitlines()[0]}",
                      flush=True)
            return None
        if not torch.equal(y.permute(0, 2, 3, 1), ref):
            raise AssertionError("torch's max_pool2d differs from K2's "
                                 "plain version")
        return library

    def check_max_pool(name, label, x, stride, pads):
        a = (3, stride, pads)
        got = k.int8_max_pool(x, *a)
        ref = k.int8_max_pool_plain(x, *a)
        record(name, label, got, ref, lambda: k.int8_max_pool(x, *a),
               lambda: k.int8_max_pool_plain(x, *a), pool_work(x, got, 3),
               max_pool_library(x, stride, pads, ref))

    def check_convs(name, cases):
        for label, x, w, stride, pad in cases:
            O, kh, kw, C = w.shape
            library = None
            if kh == kw == 1 and stride == 1 and x.is_contiguous():
                # the same GEMM on cuBLASLt, s32 out, no epilogue
                x2, w2 = x.view(-1, C), w.view(O, C).t()

                def library(x2=x2, w2=w2):
                    return torch._int_mm(x2, w2)
            # per-channel epilogue scales that put outputs across the int8
            # range
            spread = float(C * kh * kw) ** 0.5 * 64 * 73
            m = (torch.rand(O, generator=g, device=dev) + 0.5) * (64.0
                                                                   / spread)
            bq = torch.randn(O, generator=g, device=dev) * 8.0
            for out_dtype, tag in ((torch.int8, "i8"),
                                   (torch.bfloat16, "bf16")):
                def fn(x=x, w=w, m=m, bq=bq, s=stride, p=pad, o=out_dtype):
                    return k.int8_conv(x, w, m, bq, s, p, o)

                def plain(x=x, w=w, m=m, bq=bq, s=stride, p=pad,
                          o=out_dtype):
                    return k.int8_conv_plain(x, w, m, bq, s, p, o)

                got = fn()
                record(name, f"{label}/{tag}", got, plain(), fn, plain,
                       conv_work(x, w, got), library)

    # K1: the 3a fused entry conv, a 3a 3x3 reading its slice of the entry
    # output in place, the 3c 3x3 s2, a 4e 3x3 s2, the 5b fused entry conv
    entry3a = act(SLICE_N, 28, 28, 192)
    check_convs("int8_conv", [
        ("3a_entry_1x1", entry3a, weights(192, 1, 1, 192), 1, 0),
        ("3a_3x3_on_slice", entry3a[..., 64:128], weights(64, 3, 3, 64), 1, 1),
        ("3c_3x3_s2", act(SLICE_N, 28, 28, 128), weights(160, 3, 3, 128), 2, 1),
        ("4e_double_3x3_2_s2", act(SLICE_N, 14, 14, 256),
         weights(256, 3, 3, 256), 2, 1),
        ("5b_entry_1x1", act(SLICE_N, 7, 7, 1024), weights(736, 1, 1, 1024),
         1, 0),
        # K1's tile tails: rows (637 crops) not a multiple of 128, columns
        # past O in the last tile, depth not a multiple of the 128-byte
        # stage; signed inputs, as the calibration conv feeds
        ("tail_3x3_O176_K720", act(SLICE_N - 3, 13, 13, 80, lo=-127),
         weights(176, 3, 3, 80), 1, 1),
        ("tail_1x1_O24_K48", act(SLICE_N - 3, 28, 28, 48, lo=-127),
         weights(24, 1, 1, 48), 1, 0),
        ("tail_3x3_s2_O40_K288", act(SLICE_N - 3, 28, 28, 32, lo=-127),
         weights(40, 3, 3, 32), 2, 1),
        ("tail_1x1_O736_K1040", act(SLICE_N - 3, 7, 7, 1040, lo=-127),
         weights(736, 1, 1, 1040), 1, 0),
    ])
    del entry3a

    # K2: the 3c and 4e passthrough ceil pools (s2) and the 5b pool branch
    # (s1 p1) on signed values, so -128 padding must never win; then grids
    # that no tile divides, with -128 and all-negative edge windows
    for label, shape, stride, kw in (
            ("3c_ceil_s2", (SLICE_N, 28, 28, 320), 2, dict(ceil=True)),
            ("4e_ceil_s2", (SLICE_N, 14, 14, 608), 2, dict(ceil=True)),
            ("5b_s1_p1", (SLICE_N, 7, 7, 1024), 1, dict(pad=1)),
            ("tail_27x29_ceil_s2", (SLICE_N - 3, 27, 29, 336), 2,
             dict(ceil=True)),
            ("tail_9x11_s1_p1", (SLICE_N - 3, 9, 11, 96), 1, dict(pad=1))):
        x = (edge_input(*shape) if label.startswith("tail")
             else act(*shape) - 64)
        check_max_pool("int8_max_pool", label, x, stride,
                       pool_pads(shape[1], shape[2], 3, stride, **kw))
        del x

    # K3: the 3a pool branch
    x = act(SLICE_N, 28, 28, 192)
    got = k.int8_avg_pool(x, 3, 1, 1)
    record("int8_avg_pool", "3a_s1_p1", got, k.int8_avg_pool_plain(x, 3, 1, 1),
           lambda: k.int8_avg_pool(x, 3, 1, 1),
           lambda: k.int8_avg_pool_plain(x, 3, 1, 1), pool_work(x, got, 3))
    del x

    # InceptionV3 at 299^2 (35/17/8 grids): K1 with per-axis pads, on the
    # Mixed_5b fused entry conv (64 | 48 | 64) and convs reading its slices
    entry5b = act(SLICE_N, 35, 35, 176)
    check_convs("int8_conv/per_axis_pad", [
        ("5b_entry_1x1", act(SLICE_N, 35, 35, 192),
         weights(176, 1, 1, 192), 1, (0, 0)),
        ("5b_branch5x5_2_5x5_p2_on_slice", entry5b[..., 64:112],
         weights(64, 5, 5, 48), 1, (2, 2)),
        ("5b_branch3x3dbl_2_on_slice", entry5b[..., 112:176],
         weights(96, 3, 3, 64), 1, (1, 1)),
        ("6a_branch3x3_3x3_s2_valid", act(SLICE_N, 35, 35, 288),
         weights(384, 3, 3, 288), 2, (0, 0)),
        ("6b_branch7x7_2_1x7", act(SLICE_N, 17, 17, 128),
         weights(128, 1, 7, 128), 1, (0, 3)),
        ("6b_branch7x7_3_7x1", act(SLICE_N, 17, 17, 128),
         weights(192, 7, 1, 128), 1, (3, 0)),
        ("7b_branch3x3_2a_1x3", act(SLICE_N, 8, 8, 384),
         weights(384, 1, 3, 384), 1, (0, 1)),
    ])
    del entry5b
    # K2 without padding: the Mixed_6a and Mixed_7a pool branches
    for label, x in (("6a_35_to_17", act(SLICE_N, 35, 35, 288) - 64),
                     ("7a_17_to_8", act(SLICE_N, 17, 17, 768) - 64)):
        check_max_pool("int8_max_pool/valid", label, x, 2, ((0, 0), (0, 0)))
    # K3's exclude-pad mode: the Mixed_5d, 6b and 7c pool branches
    for label, x in (("5d_35", act(SLICE_N, 35, 35, 288)),
                     ("6b_17", act(SLICE_N, 17, 17, 768)),
                     ("7c_8", act(SLICE_N, 8, 8, 2048))):
        got = k.int8_avg_pool_exclude_pad(x, 3, 1, 1)
        record("int8_avg_pool/exclude_pad", label, got,
               k.int8_avg_pool_plain(x, 3, 1, 1, count_include_pad=False),
               lambda x=x: k.int8_avg_pool_exclude_pad(x, 3, 1, 1),
               lambda x=x: k.int8_avg_pool_plain(x, 3, 1, 1,
                                                 count_include_pad=False),
               pool_work(x, got, 3))
    del x
    torch.cuda.empty_cache()

    # A1: the backward of every BNInception max pool at the training
    # step's 1,152 images, float32 (the trainer's dtype) and the stem pool
    # in bfloat16; post-ReLU inputs, so windows of zeros tie
    for label, (H, C), stride, pads, dtype in (
            ("stem1_ceil_s2", (112, 64), 2, pool_pads(112, 112, 3, 2, True),
             torch.float32),
            ("stem2_ceil_s2", (56, 192), 2, pool_pads(56, 56, 3, 2, True),
             torch.float32),
            ("3c_ceil_s2", (28, 320), 2, pool_pads(28, 28, 3, 2, True),
             torch.float32),
            ("4e_ceil_s2", (14, 576), 2, pool_pads(14, 14, 3, 2, True),
             torch.float32),
            ("5b_s1_p1", (7, 1024), 1, pool_pads(7, 7, 3, 1, pad=1),
             torch.float32),
            ("stem1_ceil_s2/bf16", (112, 64), 2,
             pool_pads(112, 112, 3, 2, True), torch.bfloat16)):
        x = torch.relu(torch.randn(TRAIN_N, H, H, C, generator=g,
                                   device=dev)).to(dtype)
        geo = ((3, 3), (stride, stride), pads)
        y = _reduce_max(x, *geo).contiguous()
        dy = torch.randn(y.shape, generator=g, device=dev).to(dtype)
        got = a1.max_pool_bwd(x, y, dy, *geo)
        again = a1.max_pool_bwd(x, y, dy, *geo)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        if not torch.equal(got.view(bits), again.view(bits)):
            raise AssertionError(f"max_pool_bwd[{label}]: two launches on "
                                 "the same inputs differ")
        del again
        # |x| + |y| + |dy| + |dx| across HBM once; 9 compares and an add
        # per window; the plain version is torch's own max-pool backward
        plain = (lambda x=x, dy=dy, geo=geo:
                 a1.max_pool_bwd_plain(x, dy, *geo))
        record("max_pool_bwd", label, got, plain(),
               lambda x=x, y=y, dy=dy, geo=geo: a1.max_pool_bwd(x, y, dy,
                                                                *geo),
               plain, work(2 * (x.numel() + y.numel()) * x.element_size(),
                           10 * y.numel(), CORE_OPS), plain)
        del x, y, dy, got
    torch.cuda.empty_cache()
    return rows


def write_fixture(d: str, n_videos: int = 2, frames: int = 1560,
                  split: str = "thumos14_tag_test",
                  num_class: int = 20) -> str:
    """A proposal list (the repo's test-fixture format) with fg, incomplete
    and background proposals per video."""
    lines = []
    for v in range(n_videos):
        gt = [(1 + v % num_class, 260, 780),
              (1 + (v + 7) % num_class, 1040, 1352)]
        props = []
        for g in gt:
            props += [(g[0], 0.85, 0.9, g[1] - 52, g[2] + 13),
                      (g[0], 0.75, 0.95, g[1] + 13, g[2] - 39),
                      (g[0], 0.2, 0.9, g[1] + 78, g[1] + 286),
                      (g[0], 0.15, 0.85, g[1] + 130, g[1] + 338)]
        props += [(0, 0.0, 0.0, 1378, 1547), (0, 0.005, 0.0, 26, 234)]
        vid = f"video_{split.rsplit('_', 1)[-1]}_{v:07d}"
        lines.append(f"# {v}\n{vid}\n{frames}\n1\n{len(gt)}\n")
        lines += [f"{g[0]} {g[1]} {g[2]}\n" for g in gt]
        lines.append(f"{len(props)}\n")
        lines += [f"{p[0]} {p[1]:.4f} {p[2]:.4f} {p[3]} {p[4]}\n"
                  for p in props]
    path = os.path.join(d, f"{split}_proposal_list.txt")
    with open(path, "w") as f:
        f.writelines(lines)
    return path


def _train_setup(d: str, device: str, seed: int, dropout: float = 0.8,
                 crop: int = 224, frame_hw=(256, 340)):
    """A THUMOS14 training set-up on the port: dataset, augmentation
    (scale + center crop + random flip, no resize at these frame sizes),
    seeded BNInception SSN, optimizer (clip 20) and ``make_train_step``."""
    import numpy as np

    from action_detection_torch.config import get_configs
    from action_detection_torch.data.pipeline import (SyntheticFrameProvider,
                                                      assemble_train_batch)
    from action_detection_torch.data.ssn_dataset import SSNDataset
    from action_detection_torch.data.transforms import (
        Compose, GroupCenterCrop, GroupRandomHorizontalFlip, GroupScale)
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.train import make_optimizer, make_train_step

    cfg = get_configs("thumos14")
    ds = SSNDataset(os.path.join(d, f"{cfg.train_list}_proposal_list.txt"),
                    cfg.sampling)
    model = seeded_init(SSN(num_class=cfg.num_class, dropout=dropout,
                            stpp_cfg=cfg.stpp), seed=seed).to(device)
    aug = Compose([GroupScale(frame_hw[0]), GroupCenterCrop(crop),
                   GroupRandomHorizontalFlip()])
    provider = SyntheticFrameProvider(width=frame_hw[1], height=frame_hw[0])
    rng = np.random.RandomState(seed)

    def batch(videos):
        return assemble_train_batch(ds, videos, provider, aug, rng)

    # seeded random weights start with gradient norms in the thousands:
    # the clip keeps four steps finite
    opt = make_optimizer(model, base_lr=0.001, lr_steps=[3, 6],
                         steps_per_epoch=max(len(ds) // TRAIN_VIDEOS, 1),
                         clip_gradient=20.0)
    step = make_train_step(model, opt, cfg.sampling, seed=seed)
    return model, batch, step


def run_training(d: str) -> dict:
    """Main path, part 2: ``TRAIN_STEPS`` SGD steps at full width."""
    import numpy as np
    import torch

    from action_detection_torch.train import batch_to_device

    _, make_batch, step = _train_setup(d, "cuda", seed=1)
    t0 = time.perf_counter()
    batches = [make_batch(range(i * TRAIN_VIDEOS, (i + 1) * TRAIN_VIDEOS))
               for i in range(TRAIN_STEPS)]
    host_s = time.perf_counter() - t0
    if batches[0]["frames"].shape != (TRAIN_VIDEOS * 8, 9, 224, 224, 3):
        raise AssertionError(f"batch {batches[0]['frames'].shape}")
    ms, metrics = [], []
    for b in batches:
        db = batch_to_device(b, "cuda")
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        met = step(db)
        e.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(e))
        metrics.append({k: v.item() for k, v in met.items()})
    for m in metrics:
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite training metrics {m}")
    print(f"main path: {TRAIN_STEPS} train steps of {TRAIN_N} images, "
          f"loss {[round(m['loss'], 5) for m in metrics]}, grad norm "
          f"{[round(m['grad_norm'], 5) for m in metrics]}; host batch "
          f"assembly {host_s:.1f} s", flush=True)
    return {"ms": ms, "step": step, "batch": db}


def check_train_step_small(d: str) -> None:
    """Loss and gradients of one small train step (64^2 crops, one video,
    dropout 0). On the card with A1 as the max-pool backward against the
    same step on the card with torch's own max-pool backward: every
    parameter's gradient within 1e-4 of its largest element. The loss and
    metrics against the CPU: rtol 1e-3. (Gradients are not compared across
    devices: cuDNN and the CPU round the forward differently, which flips
    the argmax of near-tied pool windows and routes whole gradients
    elsewhere.)"""
    from contextlib import nullcontext
    from unittest import mock

    import numpy as np

    from action_detection_torch.config import get_configs
    from action_detection_torch.ops import pooling
    from action_detection_torch.train import batch_to_device, make_loss_fn

    def torch_pool_backward():
        # the same forward; autograd through torch's max_pool2d backward
        return mock.patch.object(pooling._MaxPool2d, "apply", staticmethod(
            lambda x, k, s, p: pooling._reduce_max(x, k, s, p)))

    cfg = get_configs("thumos14")
    res = {}
    for dev, bwd in (("cpu", "a1"), ("cuda", "a1"), ("cuda", "torch")):
        model, make_batch, _ = _train_setup(d, dev, seed=2, dropout=0.0,
                                            crop=64, frame_hw=(64, 80))
        loss_fn = make_loss_fn(model, cfg.sampling)
        batch = batch_to_device(make_batch([0]), dev)
        with torch_pool_backward() if bwd == "torch" else nullcontext():
            total, met = loss_fn(batch, True)
            total.backward()
        res[dev, bwd] = ({k: v.item() for k, v in met.items()},
                         {n: p.grad.detach().cpu()
                          for n, p in model.named_parameters()})
    (mc, _), (mg, ga), (_, gt) = (res["cpu", "a1"], res["cuda", "a1"],
                                  res["cuda", "torch"])
    for k in mc:
        if not np.isclose(mg[k], mc[k], rtol=1e-3, atol=1e-6):
            raise AssertionError(f"train step {k}: card {mg[k]} cpu {mc[k]}")
    worst = 0.0
    for name, g in gt.items():
        scale = g.abs().max().item()
        err = (ga[name] - g).abs().max().item()
        if err > 1e-4 * scale:
            raise AssertionError(f"train step gradient {name}: A1 vs torch's "
                                 f"backward |d| {err} > 1e-4 * {scale}")
        worst = max(worst, err / scale if scale > 0 else 0.0)
    print(f"check: small train step, loss on the card {mg['loss']:.6f} vs "
          f"CPU {mc['loss']:.6f}; gradients with A1 vs torch's max-pool "
          f"backward on the card: worst {worst:.2e} of the largest element",
          flush=True)


def check_pickle(path: str, num_class: int, n_videos: int = 2) -> list:
    """Shapes and finite values of a score pickle; returns the P per video."""
    import numpy as np

    with open(path, "rb") as f:
        scores = pickle.load(f)
    if len(scores) != n_videos:
        raise AssertionError(f"expected {n_videos} scored videos, got "
                             f"{len(scores)}")
    K = num_class
    for vid, (rel, act, comp, reg) in scores.items():
        P = rel.shape[0]
        if not (act.shape == (P, K + 1) and comp.shape == (P, K)
                and reg.shape == (P, K, 2)):
            raise AssertionError(f"{vid}: shapes {act.shape} "
                                 f"{comp.shape} {reg.shape}")
        for a in (act, comp, reg):
            if not np.isfinite(a).all():
                raise AssertionError(f"{vid}: non-finite scores")
    return [v[0].shape[0] for v in scores.values()]


def drive(name: str, fn, expect) -> dict:
    """One main path: the launch counts set to 0 just before ``fn()`` and
    read just after; every kernel in ``expect`` must have launched."""
    import torch

    from action_detection_torch.kernels import (launch_counts,
                                                reset_launch_counts)

    reset_launch_counts()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    print(f"main path {name}: wall {wall:.2f} s, launches {launches}",
          flush=True)
    for kname in expect:
        if launches[kname] <= 0:
            raise AssertionError(f"{kname} never launched on the {name} "
                                 "path")
    return launches


def _seeded_checkpoint(d: str, name: str, num_class: int, arch: str,
                       modality: str, seed: int):
    """A seeded SSN saved as ``d/name.pt`` with reg_stats; returns the
    model (CPU) and the path."""
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.train import save_checkpoint

    model = seeded_init(SSN(num_class=num_class, base_model=arch,
                            modality=modality, dropout=0.0), seed=seed)
    path = os.path.join(d, f"{name}.pt")
    save_checkpoint(path, model.state_dict(), REG_STATS, arch=arch)
    return model, path


def main_path(card: str, smi: str, profile: str = None) -> dict:
    """Phases 4 and 5: the four main paths at full width, then the checks
    and the timings. Returns each path's launch counts."""
    import torch

    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.models import SSN, seeded_init

    paths = {}
    models = {}
    with tempfile.TemporaryDirectory() as d:
        write_fixture(d)
        write_fixture(d, n_videos=4, split="thumos14_tag_val")
        write_fixture(d, split="activitynet1.2_tag_val", num_class=100)
        clis = {}
        for key, dataset, arch, modality, K, seed in (
                ("bninception_rgb", "thumos14", "BNInception", "RGB", 20, 0),
                ("inceptionv3_rgb", "activitynet1.2", "InceptionV3", "RGB",
                 100, 3),
                ("bninception_flow", "thumos14", "BNInception", "Flow", 20,
                 4)):
            models[key], ckpt = _seeded_checkpoint(d, key, K, arch,
                                                   modality, seed)
            out = os.path.join(d, f"{key}.pkl")
            clis[key] = ([dataset, modality, ckpt, out, "--arch", arch,
                          "--synthetic_data", "--prop_file_dir", d], out, K)

        int8_kernels = ("int8_conv", "int8_max_pool")
        cli, out, K = clis["bninception_rgb"]
        paths["bninception_rgb"] = drive(
            "ssn_test thumos14 RGB (BNInception)", lambda: ssn_test(cli),
            int8_kernels + ("int8_avg_pool",))
        print(f"main path: pickle ok (P={check_pickle(out, K)})", flush=True)
        # the scorer turned TF32 off; the training steps keep it off
        torch.backends.cudnn.allow_tf32 = False
        train = {}
        paths["train"] = drive(
            f"train ({TRAIN_STEPS} steps)",
            lambda: train.update(run_training(d)), ("max_pool_bwd",))
        cli3, out, K = clis["inceptionv3_rgb"]
        paths["inceptionv3_rgb"] = drive(
            "ssn_test activitynet1.2 RGB --arch InceptionV3",
            lambda: ssn_test(cli3),
            int8_kernels + ("int8_avg_pool_exclude_pad",))
        print(f"main path: pickle ok (P={check_pickle(out, K)})", flush=True)
        clif, out, K = clis["bninception_flow"]
        paths["bninception_flow"] = drive(
            "ssn_test thumos14 Flow (BNInception)", lambda: ssn_test(clif),
            int8_kernels + ("int8_avg_pool",))
        print(f"main path: pickle ok (P={check_pickle(out, K)})", flush=True)

        check_train_step_small(d)
        if profile:
            profile_cli(profile, "ssn_test", clis["bninception_rgb"][0])
            profile_cli(profile, "ssn_test_iv3", clis["inceptionv3_rgb"][0])

    scorers = [check_bninception(models["bninception_rgb"], smi),
               check_inceptionv3(models["inceptionv3_rgb"], smi),
               time_flow(models["bninception_flow"], smi)]
    iv3_flow = seeded_init(SSN(num_class=100, base_model="InceptionV3",
                               modality="Flow", dropout=0.0), seed=5)
    scorer, _ = time_flow(iv3_flow, smi, hw=(341, 452))
    scorer.close()
    train_ms = statistics.median(train["ms"][1:])
    print(f"train: {train_ms:.2f} ms per {TRAIN_N}-image step (median of "
          f"steps 2-{TRAIN_STEPS}, first {train['ms'][0]:.2f} ms) = "
          f"{TRAIN_N / train_ms * 1e3:.0f} images/s, float32, TF32 off "
          f"({smi})", flush=True)
    if profile:
        train_step = lambda: train["step"](train["batch"])    # noqa: E731
        for name, (_, step) in zip(("score_step", "score_step_iv3",
                                    "score_step_flow"), scorers):
            profile_calls(profile, name, step, reps=3)
        profile_calls(profile, "train_step", train_step, reps=2)
    for scorer, _ in scorers:
        scorer.close()
    return paths


def _int8_checks(name, model, qe, x, stem_quantized, trunk_ops, trunk,
                 features):
    """The int8 trunk on the card against the plain kernels on the CPU
    (bit-exact activations; features within rtol 1e-6, since the
    dequantizing mean may round differently across devices), then the int8
    features against the float backbone (min cos > 0.99, rel RMS < 0.12)."""
    import torch

    from action_detection_torch.models.backbones.bn_inception_int8 import (
        tree_to)

    with torch.no_grad():
        h = stem_quantized(qe, x)
        qe_cpu = tree_to(qe, "cpu")
        got = trunk_ops(qe, h).cpu()
        ref = trunk_ops(qe_cpu, h.cpu())
        if not torch.equal(got, ref):
            raise AssertionError(f"{name} int8 trunk on the card differs "
                                 "from the plain kernels on the CPU in "
                                 f"{(got != ref).sum().item()} values")
        fgot = trunk(qe, h).cpu()
        fref = trunk(qe_cpu, h.cpu())
        torch.testing.assert_close(fgot, fref, rtol=1e-6, atol=0)
        print(f"check: {name} int8 trunk activations (K1-K3 on the card) == "
              f"plain versions on the CPU, bit-exact, {tuple(got.shape)}; "
              f"features max |d| {(fgot - fref).abs().max().item()}",
              flush=True)
        fmodel = model.to("cuda").eval()
        f32 = fmodel.base_model(x).double().cpu()
        q8 = features(qe, x).double().cpu()
        model.to("cpu")
    cos = torch.nn.functional.cosine_similarity(f32, q8, dim=1).min()
    rel = ((q8 - f32).norm() / f32.norm()).item()
    if not (cos > 0.99 and rel < 0.12):
        raise AssertionError(f"{name} int8 features vs float: cos {cos} "
                             f"rel {rel}")
    print(f"check: {name} int8-e2e vs float features: min cos "
          f"{cos.item():.6f}, rel rms {rel:.5f}", flush=True)


def _time_steps(name, model, frames, calib, smi, modality="RGB"):
    """Steady-state 640-crop step of the int8-e2e shared-stem scorer and of
    the float backbone (TF32 off) on one chunk of scale-size frames.
    Returns the int8 scorer and its step function."""
    import numpy as np
    import torch

    from action_detection_torch.infer.scorer import ProposalScorer
    from action_detection_torch.kernels import (launch_counts,
                                                reset_launch_counts)

    spec = model.input_spec
    kw = dict(reg_stats=np.asarray(REG_STATS, np.float32),
              num_class=model.num_class, chunk_frames=64, modality=modality,
              device="cuda")
    scorer = ProposalScorer(model, spec, quantize="e2e",
                            calibration_frames=calib, shared_stem=True, **kw)
    chunk = torch.as_tensor(frames).cuda()
    step = lambda: scorer._score_chunk(chunk, 64)      # noqa: E731
    step_ms = _time_ms(step, reps=10, warmup=2)
    reset_launch_counts()
    step()
    per_step = {k: n for k, n in launch_counts().items() if n}
    line = (f"step: {name} int8-e2e shared-stem {step_ms:.2f} ms per "
            f"{SLICE_N}-crop step = {SLICE_N / step_ms * 1e3:.0f} crops/s, "
            f"launches per step {per_step}")
    if modality == "RGB":
        fscorer = ProposalScorer(model, spec, quantize=False, **kw)
        float_ms = _time_ms(lambda: fscorer._score_chunk(chunk, 64), reps=5,
                            warmup=1)
        fscorer.close()
        model.to("cpu")
        line += (f"; float32 backbone {float_ms:.2f} ms = "
                 f"{SLICE_N / float_ms * 1e3:.0f} crops/s")
    print(f"{line} ({smi})", flush=True)
    return scorer, step


def check_bninception(model, smi):
    """BNInception RGB at 224^2 from 340x256 frames."""
    import numpy as np
    import torch

    from action_detection_torch.data.transforms import (
        device_oversample_normed)
    from action_detection_torch.models.backbones import (
        bn_inception_int8 as bq)

    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, size=(64, 256, 340, 3), dtype=np.uint8)
    calib = np.concatenate([frames[:2, 16:240, 58:282]] * 5)   # 10 crops
    scorer, step = _time_steps("BNInception", model, frames, calib, smi)
    x = device_oversample_normed(torch.as_tensor(frames[:2]).cuda(),
                                 model.input_spec)     # (20, 224, 224, 3)
    _int8_checks("BNInception", model, scorer._quantized, x,
                 bq._e2e_stem_quantized,
                 lambda qe, h: bq._walk_trunk(bq._E2EOps(qe), h),
                 bq._e2e_trunk, bq.bninception_int8_e2e_features)
    return scorer, step


def check_inceptionv3(model, smi):
    """InceptionV3 RGB at 299^2: the host's decode + resize of a 64-tick
    chunk of 340x256 frames to 452x341, then the checks and step times on
    a chunk of scale-size frames."""
    import numpy as np
    import torch

    from action_detection_torch.data.pipeline import (SyntheticFrameProvider,
                                                      iter_scaled_frame_chunks,
                                                      make_decode_pool)
    from action_detection_torch.data.transforms import (
        device_oversample_normed)
    from action_detection_torch.models.backbones import (
        inception_v3_int8 as iq)

    spec = model.input_spec
    pool = make_decode_pool(None)
    t0 = time.perf_counter()
    chunk = next(iter_scaled_frame_chunks(
        SyntheticFrameProvider(), "video_0", np.arange(1, 64 * 6, 6), 1560,
        spec.scale_size, batch_ticks=64, executor=pool))
    host_s = time.perf_counter() - t0
    pool.shutdown()
    if chunk.shape != (64, 341, 452, 3):
        raise AssertionError(f"scaled chunk {chunk.shape}")
    print(f"host: synthetic decode + numpy resize of a 64-tick chunk "
          f"(340x256 -> 452x341) {host_s:.3f} s on "
          f"{min(8, 2 * (os.cpu_count() or 1))} threads, "
          f"{os.cpu_count()} cores", flush=True)

    calib = np.concatenate([chunk[:2, 21:320, 76:375]] * 5)   # 10 crops
    scorer, step = _time_steps("InceptionV3", model, chunk, calib, smi)

    class Acts(iq._ForwardOps):        # the last concat, before the mean
        def finish(self, y):
            return y

    x = device_oversample_normed(torch.as_tensor(chunk[:1]).cuda(),
                                 spec)[:4]              # (4, 299, 299, 3)
    _int8_checks("InceptionV3", model, scorer._quantized, x,
                 iq._iv3_stem_quantized,
                 lambda qe, h: iq._walk_trunk(Acts(qe), h), iq.iv3_trunk,
                 iq.inception_v3_int8_e2e_features)
    return scorer, step


def time_flow(model, smi, hw=(256, 340)):
    """Flow: 64 ticks of 10-channel stacks at scale size ``hw``."""
    import numpy as np

    rng = np.random.RandomState(1)
    frames = rng.randint(0, 256, size=(64,) + hw + (10,), dtype=np.uint8)
    cs = model.input_spec.input_size
    oy, ox = (hw[0] - cs) // 2, (hw[1] - cs) // 2
    calib = np.concatenate([frames[:2, oy:oy + cs, ox:ox + cs]] * 5)
    return _time_steps(f"{model.arch} Flow", model, frames, calib, smi,
                       modality="Flow")


def _device_intervals(prof):
    """(start, end, name) in us of every device-side event."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out.append((e.time_range.start, e.time_range.end, e.name))
    return out


def _busy_us(intervals) -> float:
    """Length of the union of the intervals."""
    total, end = 0.0, None
    for a, b, _ in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def _profile_out(out_dir: str, name: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"profile_{name}.txt")


def profile_calls(out_dir: str, name: str, fn, reps: int) -> None:
    """Per-kernel device ms per call and the busy share over ``reps``
    back-to-back calls of ``fn`` (after two warm-up calls)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    iv = _device_intervals(prof)
    busy = _busy_us(iv)
    by_name = {}
    for a, b, n in iv:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    total = sum(by_name.values())
    with open(_profile_out(out_dir, name), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total",
                                          row_limit=60))
    print(f"profile {name}: device time {total / reps / 1e3:.2f} ms per "
          f"call, wall {wall_us / reps / 1e3:.2f} ms, device busy "
          f"{busy / wall_us:.1%}", flush=True)
    for n, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"profile {name}:   {us / reps / 1e3:9.3f} ms "
              f"{us / total:6.1%}  {n[:90]}", flush=True)


def profile_cli(out_dir: str, name: str, cli) -> None:
    """Device busy share of one whole ``ssn_test`` run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from action_detection_torch.cli.ssn_test import main as ssn_test

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ssn_test(cli)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    busy = _busy_us(_device_intervals(prof))
    with open(_profile_out(out_dir, name), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=40))
    print(f"profile {name}: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms = {busy / wall_us:.1%}", flush=True)


def kernels_of(pkg_root: str) -> int:
    """Phase 3 alone on the kernels of the checkout at ``pkg_root`` (its
    ``action_detection_torch`` package; the wrappers' signatures are the
    same in every version), so two versions are timed by one method."""
    import torch

    sys.path.insert(0, pkg_root)
    from action_detection_torch.kernels.build import build_library

    smi = _smi()
    path, secs = build_library()
    print(f"kernels of {pkg_root}: {smi}, built {path} in {secs:.1f} s",
          flush=True)
    rows = check_kernels(torch.cuda.get_device_name(0))
    print(json.dumps({"kernels_of": pkg_root, "ms": {
        f"{name}[{r['label']}]": r["ms"] for name, shapes in rows.items()
        for r in shapes}}))
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args and (args[0] not in ("--profile", "--kernels-of")
                 or len(args) != 2):
        print("usage: python3 chip_smoke.py [--profile DIR | --kernels-of "
              "CHECKOUT]", file=sys.stderr)
        return 2
    if args and args[0] == "--kernels-of":
        return kernels_of(os.path.abspath(args[1]))
    profile = os.path.abspath(args[1]) if args else None
    sys.path.insert(0, ROOT)
    # the port must be importable before anything is printed
    from action_detection_torch.kernels.build import build_library

    smi = _smi()
    card = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {sys.version.split()[0]}", flush=True)

    path, secs = build_library()
    print(f"build: {os.path.relpath(path, ROOT)} in {secs:.1f} s", flush=True)

    rows = check_kernels(card)
    paths = main_path(card, smi, profile)

    conv, pool = ("action_detection_torch/csrc/int8_conv.cu",
                  "action_detection_torch/csrc/int8_pool.cu")
    # row -> (source, TPU function it replaces, main path, launch counter)
    sources = {
        "int8_conv": (conv, f"{TPU_SRC}:257", "bninception_rgb",
                      "int8_conv"),
        "int8_conv/per_axis_pad": (conv, f"{IV3_SRC}:288", "inceptionv3_rgb",
                                   "int8_conv"),
        "int8_max_pool": (pool, f"{TPU_SRC}:230", "bninception_rgb",
                          "int8_max_pool"),
        "int8_max_pool/valid": (pool, f"{IV3_SRC}:300", "inceptionv3_rgb",
                                "int8_max_pool"),
        "int8_avg_pool": (pool, f"{TPU_SRC}:244", "bninception_rgb",
                          "int8_avg_pool"),
        "int8_avg_pool/exclude_pad": (pool, f"{IV3_SRC}:305",
                                      "inceptionv3_rgb",
                                      "int8_avg_pool_exclude_pad"),
        "max_pool_bwd": ("action_detection_torch/csrc/pool_bwd.cu",
                         "action_detection_tpu/ops/pool_bwd_pallas.py:262",
                         "train", "max_pool_bwd")}
    kernels = []
    for name, shapes in rows.items():
        src, replaces, path, counter = sources[name]
        lib = [r["library_ms"] for r in shapes if r["library_ms"] is not None]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": paths[path][counter],
            "max_abs_err": max(r["err"] for r in shapes),
            # summed over the shapes checked above; library_ms over the
            # shapes that have a library call (K1: its 1x1 shapes)
            "ms": sum(r["ms"] for r in shapes),
            "plain_ms": sum(r["plain_ms"] for r in shapes),
            "bound_ms": sum(r["bound_ms"] for r in shapes),
            "bound_by": max(shapes, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": sum(lib) if lib else None})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
