"""Smoke test of the PyTorch port on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero
before the final line):

1. device   — the card's name and power limit (nvidia-smi), torch and CUDA
              versions. No CUDA device: exit 1.
2. build    — nvcc builds the kernels K1-K3 and A1, and g++ the C++ host
              kernels (NMS, TAG box search; the frame decoder at its
              first phase), from
              ``action_detection_torch/csrc`` into
              ``action_detection_torch/_build``.
3. kernels  — K1 (int8 conv, both epilogues), K2 (int8 max pool, both
              variants) and K3 (int8 avg pool) at the BNInception scoring
              shapes (640 crops; K2 at 3c, 4e and 5b); K1 with per-axis
              pads (5x5, 1x7, 7x1, 1x3, VALID 3x3 s2, a fused entry conv
              and a conv on its channel slice), K2 without padding and K3's
              exclude-pad mode at InceptionV3's 640-crop shapes; K1's bf16
              epilogue at the per-layer (``--int8_mode perlayer``) shapes:
              the 7x7 s2 stem conv on 16 channels of which 3 carry pixels,
              conv2_3x3 and two unfused 1x1s; K1 at tile
              tails (rows, columns and depth not multiples of the tile) and
              K2 at grids no tile divides, with signed inputs (K2's with
              -128 and all-negative windows at the padded edges); K1's
              int8 epilogue and K2 at the all-int8 stems' geometries
              (BNInception's 7x7 s2 conv on 16 channels of which 3 are
              real, its 1x1 and 3x3, its two Caffe-ceil pools;
              InceptionV3's five stem convs and two VALID pools; at the
              shared stem's 128 frames and at 640 crops); and A1
              (max-pool backward) at every BNInception max pool of the
              training step (1,152 images) in float32 and in bfloat16, at
              InceptionV3's four VALID pools (the InceptionV3 training
              run's ``IV3_TRAIN_VIDEOS`` x 72 images); A1 at ResNet's stem
              pool (3x3 s2, pad 1) and VGG-16's five 2x2 s2 pools, float32
              and bfloat16, follows in phase 4 at their training runs'
              images, once the memory probe has fixed their -b. Each is
              held EXACTLY equal to
              its plain torch version on the same inputs; median ms of
              both, the bound (``work``: the larger of the bytes over 3.35
              TB/s and the operations over the peak of their type) and,
              where one PyTorch call computes the same function, that
              call's ms (``torch._int_mm`` for K1's 1x1 shapes: the GEMM
              without the epilogue; torch's max-pool backward for A1;
              ``F.max_pool2d`` on the channels-last view for K2, where
              torch's CUDA max pool takes int8). A1 also launches twice on
              the same inputs (equal bits).
4. main     — the main paths, each with the launch counts set to 0 just before
              it and read just after, each required to launch its kernels:
              the port's ``ssn_test`` CLI in-process at full width with the
              int8-e2e shared-stem default and seeded random weights, on 2
              synthetic videos of 1,560 frames each, for BNInception RGB
              (THUMOS14, 224^2), InceptionV3 RGB (ActivityNet v1.2, K=100,
              340x256 frames resized to 452x341 on the host, 299^2 crops;
              K3 in its exclude-pad mode) and BNInception Flow (THUMOS14,
              new_length 5: 10-channel stacks); then the rest of the
              scoring CLI surface (``run_scoring_surface``): ``ssn_test
              --int8_mode perlayer`` (K1 alone: its pools are bf16 torch
              ops, so K2 and K3 must not launch), ``ssn_test`` RGBDiff (the
              shared-stem default on 15-channel differences of 6 frames),
              ``ssn_test --test_crops 1`` (host center crops, int8-e2e per
              crop) and ``binary_test --host_crops`` (10 host crops), each
              a path of its own that must launch K1-K3 (perlayer: K1);
              then the all-int8 stems (``run_int8_stem``, phase
              int8_stem): for BNInception RGB and Flow and InceptionV3
              RGB, a tree from ``calibrate_e2e``/``calibrate_e2e_iv3(...,
              hybrid_stem=False)`` scored through the shared-stem scorer's
              ``prequantized=`` (one video, a path of its own: K1-K3, K1
              and K2 also at the stem), its 640-crop step timed beside the
              hybrid one in turns, its stem and trunk on the card
              bit-exact against the plain kernels on the CPU, its features
              against float (min cos > 0.99, rel < 0.12) and against the
              hybrid stem's; ``quantization_report`` in both modes on
              BNInception RGB with the fused test FC and layout (phase
              quantization_report: cos > 0.99, rel < 0.1); and SSN
              training steps at
              full width (BNInception 224^2, 16 videos x 8 proposals x 9
              segments = 1,152 images per step, frozen BN, dropout 0.8)
              through ``make_train_step``, then one such step from the
              same weights in each max-pool backward mode (phase
              pool_modes, ``run_pool_modes``: ``"pallas"`` and ``"sas"``
              (first-match, A1 at every pool) and ``"eq_mask"`` (A1 at
              its stride-1 pool only), each a path of its own that must
              launch A1; equal losses, ``"sas"`` gradients equal to
              ``"pallas"``'s bit for bit under deterministic cuDNN,
              eq-mask's gradient gap, step ms and peak memory). Each score pickle is checked for
              shapes and finite values, the training metrics for finite
              values. Then ``ssn_test`` of THUMOS14 RGB with ``--arch
              resnet101`` and ``--arch vgg16`` (float32: they have no int8
              path, so their paths launch no kernel), each with the time of
              a 640-crop float step. Then the checkpoint phase
              (``run_checkpoints``): one seeded BNInception SSN written as
              the port's ``.pt``, as a JAX ``checkpoint.msgpack`` (the
              port's msgpack writer) and as a reference ``.pth.tar`` under
              its published file name in a model cache, scored by
              ``ssn_test`` from each and by ``--use_reference`` with
              ``$ADT_MODEL_CACHE`` there: four equal pickles. Then the
              inference pipeline end to end
              (``run_pipeline``): a THUMOS14-style DB of two 1,560-frame
              test videos at 30 fps with empty frame files ->
              ``gen_sliding_window_proposals`` -> ``binary_test``
              (BNInception RGB at full width, int8-e2e shared stem, K=2,
              a path of its own: K1-K3 must launch) ->
              ``gen_bottom_up_proposals --workers 1`` (the C++ host search
              and NMS must run) -> ``ssn_test`` on the TAG list ->
              ``eval_detection_results``; then the BNInception RGB and
              Flow pickles above fused by ``eval_detection_results
              --score_weights 1 1.5``. Each stage's output is checked
              (non-empty, finite, 9 IoU columns); ``binary_test``'s wall
              time and device busy share, one 640-crop actionness chunk's
              device time and each evaluation's wall time are printed.
              Then the training CLIs in process (``run_training_clis``),
              each run a path that must launch A1: ``ssn_train thumos14
              RGB`` BNInception at -b 16 (1,152 images a step), 3 steps,
              validation, a checkpoint; ``--resume`` from it for one more
              epoch under the profiler (LR decayed at epoch 1); the port's
              ``ssn_test`` on the trained checkpoint; ``--iter_size 2``;
              ``--bf16`` (every A1 launch in bf16); Flow from the RGB
              checkpoint (``--init_weights``); RGBDiff from it (-b 4, 2
              steps) with ``ssn_test`` RGBDiff on its checkpoint (1 video);
              the largest InceptionV3 -b
              with and without ``--remat`` (``train_memory``), then
              ``ssn_train activitynet1.2 RGB --arch InceptionV3``;
              ``binary_train`` (-b 4, 240 images) with ``binary_test`` on
              its checkpoint; and for ResNet-101 and VGG-16 the largest -b
              with and without ``--remat``, then ``ssn_train thumos14 RGB``
              at the largest of -b 4, 8, 16 below the largest that fits,
              float32 and ``--bf16``. Each run prints its CLI wall time, median
              step time (CUDA events, steps 2 on), images/s, host
              batch-assembly seconds a step, peak memory and A1 launches.
              Then the data-parallel paths (``run_data_parallel``), each a
              path of its own: ``ssn_test --pack`` and ``--no_pack`` in
              turns on four videos of unequal length (``PACK_FRAMES``),
              equal pickles and fewer padded ticks (the walls, the ticks
              the device scored and K1-K3's launches printed);
              ``score_videos`` over ``[cuda:0, cuda:0]`` (two threads, two
              scorers, int8-e2e calibrated lazily) and ``binary_test``'s
              queue likewise, each equal to one device; two DDP ranks
              spawned on the card (gloo: NCCL refuses two ranks on one
              GPU) at -b ``DDP_VIDEOS`` against one rank on the same global
              batches (BNInception, ``bn_mode`` partial, dropout 0.8; loss
              and grad_norm within 1e-4, every tensor that started nonzero
              within 1e-4 of its largest value; A1 in every rank); and
              ``ssn_train -b 8`` without a process group and through the
              multi-host flags on NCCL (one rank under DDP), its
              checkpoint scored by ``ssn_test``. The ``kernels`` line
              gives each kernel's launches on these paths
              (``parallel_paths``). Then the host frame decoder
              (``check_decoder``: g++ builds ``libadt_image``; every
              committed fixture of ``tests/fixtures/torch_port_jpeg``
              (baseline, progressive, arithmetic, CMYK and YCCK,
              smoothed) and of ``tests/fixtures/torch_port_frames``
              (PNG, BMP and PNM) decoded as RGB and L to PIL's digests;
              ms a 340x256 RGB frame (baseline, progressive, arithmetic
              and progressive arithmetic JPEG; the same pixels as a PNG
              with a filter chosen a row, an Adam7 PNG, a BMP and a PPM,
              re-encoded at run time by ``tests/frame_encoders.py``) and
              a Flow x/y pair on 1 thread and on the CLIs' decode pool)
              and the CLIs on frame directories (``run_real_frames``:
              two THUMOS14 videos of 1,560 frames cycling over the
              fixtures; ``ssn_test`` BNInception RGB and Flow,
              ``binary_test`` and ``ssn_train`` -b 16, 2 steps, each a
              path that must launch its kernels and decode once a frame
              file read, beside the same run on synthetic frames, walls
              and busy shares; then ``ssn_test`` RGB on the progressive
              and arithmetic transcodes of the same frames, and on their
              PNG, BMP and PPM re-encodings under the ``img_*.jpg``
              names, each pickle byte-equal to the baseline frames' and
              each decode counted under its format); the committed
              orbax directory (``run_orbax``: read to its digests,
              scored and written back by the port where tensorstore
              imports, else reading and writing refused by name); last
              the port's THUMOS14 recipe
              (``action_detection_torch/scripts/reproduce_thumos14.sh``,
              ``run_recipe``) by ``bash`` at full width (BNInception, -b
              16; ``tests/recipe_db.py``'s dataset of 2 train and 2 test
              videos linking to the JPEG frames, its ``python`` shim
              appending ``--epochs 1``): ``gen_proposal_list`` ->
              ``ssn_train`` RGB and Flow (``$FLOW_INIT`` a seeded
              reference ``.pth``), each of which must launch A1 ->
              ``ssn_test`` RGB and Flow, each of which must launch K1-K3
              -> the fused mAP table, each step's wall printed.
5. checks   — for BNInception (RGB and RGBDiff) and InceptionV3: the
              int8-e2e trunk held bit-exact against the plain kernels on
              the CPU, the int8 features against the float backbone (cos >
              0.99, rel < 0.12); for ``--int8_mode perlayer`` (BNInception
              RGB, static scales): its activations on the card bit-exact
              against the plain kernels on the CPU at 4 crops, its features
              within one bf16 ulp there and against the float backbone at
              20 crops (cos > 0.99, rel < 0.12); a small train step on the
              card against the same step on the CPU; the host's decode +
              resize time of a 64-tick InceptionV3 chunk; and the
              steady-state times of one 640-crop scoring step (BNInception
              int8-e2e, perlayer and float, InceptionV3 int8 and float,
              BNInception RGBDiff, BNInception and InceptionV3 Flow) and
              of one training step.

``python3 chip_smoke.py --kernels-of CHECKOUT`` runs phase 3 alone on the
kernels of another checkout (e.g. a ``git archive`` of an earlier commit),
so two versions' kernels are timed by the same method on one card.

``python3 chip_smoke.py --profile DIR`` adds a torch.profiler phase: the
per-kernel device time and the device busy share of the scoring steps
(BNInception, InceptionV3, Flow, RGBDiff, perlayer), a training step and
the whole ``ssn_test`` runs of BNInception and InceptionV3, with the full
tables written to ``DIR/profile_*.txt``, and the per-layer forward's
device time by part (quantize passes, K1, bf16 max and avg pools, concats;
``perlayer_breakdown``).

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
TRAIN_STEPS = 3
TRAIN_LIST_VIDEOS = 4  # videos of the training CLIs' SSN train lists
IV3_TRAIN_VIDEOS = 8   # -b of the InceptionV3 ssn_train run (train_memory)
# the -b the ResNet-101 and VGG-16 ssn_train runs choose from: the largest
# below the largest that fits without --remat (train_memory)
RECIPE_BATCHES = (4, 8, 16)
FLOW_TRAIN_VIDEOS = 4  # -b of the Flow ssn_train run
RGBDIFF_TRAIN_VIDEOS = 4  # -b of the RGBDiff ssn_train run
HBM_GBS = 3350.0    # the H100 SXM's HBM3 bandwidth, GB/s (NVIDIA data sheet)
INT8_OPS = 1979e12  # dense int8 tensor-core peak, ops/s (NVIDIA data sheet)
CORE_OPS = 67e12    # float32 peak outside the tensor cores, ops/s (the same)
TPU_SRC = "action_detection_tpu/models/backbones/bn_inception_int8.py"
IV3_SRC = "action_detection_tpu/models/backbones/inception_v3_int8.py"
PACK_FRAMES = (1560, 1100, 700, 390)   # the pack and fan-out videos' lengths
#: the paths of ``run_data_parallel``
PARALLEL_PATHS = ("ssn_test--pack", "ssn_test--no_pack", "score_videos x1",
                  "score_videos x2", "binary_queue x1", "binary_queue x2",
                  "ddp_2_ranks", "ssn_train_plain", "ssn_train_nccl",
                  "ssn_test_nccl")
DDP_VIDEOS = 4        # -b of each of the two DDP ranks (the reference: 8)
DDP_STEPS = 2
REG_STATS = [[0.01, -0.02], [0.1, 0.2]]    # the checkpoints' reg_stats
PIPELINE_FRAMES = 1560    # frames of each pipeline test video (52 s, 30 fps)
PIPELINE_INTERVAL = 5     # binary_test's --frame_interval (its default)
JPEG_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port_jpeg")
JPEG_FIXTURE_FRAMES = 8   # img_/x_/y_ 00001..00008: 340x256 frames
FRAME_FIXTURES = os.path.join(ROOT, "tests", "fixtures", "torch_port_frames")
ORBAX_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_port_orbax")
REAL_TRAIN_STEPS = 2      # ssn_train -b 16 steps on JPEG frames
POOL_MODE_STEPS = 3       # timed training steps of each pool backward mode


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


def conv_work(x, w, out, real_c=None) -> tuple:
    """K1's bound: x (its channels only, for a slice), w, scale and bias
    read once, ``out`` written once; 2 ops per MAC at the int8 peak.
    ``real_c``: the channels that carry data where the rest are zero
    padding (a stem's 3 of 16): the function's work counts only those."""
    O, kh, kw, C = w.shape
    c = C if real_c is None else real_c
    nbytes = ((x.numel() + w.numel()) * c // C + 8 * O
              + out.numel() * out.element_size())
    return work(nbytes, 2 * out.numel() * kh * kw * c, INT8_OPS)


def pool_work(x, out, k: int) -> tuple:
    """A pool's bound: x read once, ``out`` written once; k*k window cells
    an output value at the float32 peak outside the tensor cores."""
    return work((x.numel() + out.numel()) * x.element_size(),
                out.numel() * k * k, CORE_OPS)


def record_row(rows: dict, card: str, name: str, label: str, got, ref, fn,
               plain, bound, library=None) -> None:
    """Check ``got == ref``; time the kernel, its plain version and the
    library call (``plain`` itself where the plain version is one); add the
    row to ``rows[name]``. ``bound`` is ``work(...)``'s pair."""
    import torch

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
    rows[name].append(dict(label=label, err=err, ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=lib_ms))
    lib = "" if lib_ms is None else f", library {lib_ms:.3f} ms"
    print(f"kernel {name}[{label}]: equal, max|d|={err} {ms:.3f} ms "
          f"(plain {plain_ms:.3f} ms{lib}); bound {bound_ms:.3f} ms "
          f"({bound_by}) = {bound_ms / ms:.1%} of the bound on {card}",
          flush=True)


def check_a1(rows: dict, card: str, cases, seed: int = 0) -> None:
    """A1 at each ``(label, (H, C), kernel, stride, pads, dtype, N)`` case:
    launched twice on the same post-ReLU input (equal bits; windows of
    zeros tie), held EXACTLY equal to its plain version, timed beside it,
    its bound and torch's max-pool backward (``rows["max_pool_bwd"]``)."""
    import torch

    from action_detection_torch.kernels import pool_bwd as a1
    from action_detection_torch.ops.pooling import _reduce_max

    g = torch.Generator(device="cuda").manual_seed(seed)
    for label, (H, C), k, stride, pads, dtype, N in cases:
        x = torch.relu(torch.randn(N, H, H, C, generator=g,
                                   device="cuda")).to(dtype)
        geo = ((k, k), (stride, stride), pads)
        y = _reduce_max(x, *geo).contiguous()
        dy = torch.randn(y.shape, generator=g, device="cuda").to(dtype)
        got = a1.max_pool_bwd(x, y, dy, *geo)
        again = a1.max_pool_bwd(x, y, dy, *geo)
        bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
        if not torch.equal(got.view(bits), again.view(bits)):
            raise AssertionError(f"max_pool_bwd[{label}]: two launches on "
                                 "the same inputs differ")
        del again
        # |x| + |y| + |dy| + |dx| across HBM once; k*k compares and an add
        # per window; the plain version is torch's own max-pool backward
        plain = (lambda x=x, dy=dy, geo=geo:
                 a1.max_pool_bwd_plain(x, dy, *geo))
        record_row(rows, card, "max_pool_bwd", label, got, plain(),
                   lambda x=x, y=y, dy=dy, geo=geo: a1.max_pool_bwd(
                       x, y, dy, *geo),
                   plain, work(2 * (x.numel() + y.numel()) * x.element_size(),
                               (k * k + 1) * y.numel(), CORE_OPS), plain)
        del x, y, dy, got
        torch.cuda.empty_cache()


def both_dtypes(pools, n: int) -> list:
    """float32 and bfloat16 ``check_a1`` cases of ``pools`` at ``n``
    images."""
    import torch

    return ([b + (torch.float32, n) for b in pools]
            + [(f"{b[0]}/bf16",) + b[1:] + (torch.bfloat16, n)
               for b in pools])


def check_kernels(card: str) -> list:
    """Phase 3: K1-K3 against their plain versions at the slice's shapes."""
    import torch

    from action_detection_torch.kernels import int8 as k
    from action_detection_torch.models.backbones.bn_inception import pool_pads

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def act(*shape, lo=0):   # post-ReLU int8 activations, or signed
        return torch.randint(lo, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def weights(O, kh, kw, C):
        return torch.randint(-127, 128, (O, kh, kw, C), generator=g,
                             device=dev, dtype=torch.int8)

    rows = {"int8_conv": [], "int8_conv/per_axis_pad": [],
            "int8_conv/perlayer": [], "int8_conv/int8_stem": [],
            "int8_conv/int8_stem_iv3": [],
            "int8_max_pool": [], "int8_max_pool/valid": [],
            "int8_max_pool/stem": [], "int8_max_pool/stem_iv3": [],
            "int8_avg_pool": [], "int8_avg_pool/exclude_pad": [],
            "max_pool_bwd": []}

    def record(name, label, got, ref, fn, plain, bound, library=None):
        record_row(rows, card, name, label, got, ref, fn, plain, bound,
                   library)

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

    def check_convs(name, cases, epilogues=((torch.int8, "i8"),
                                            (torch.bfloat16, "bf16"))):
        for label, x, w, stride, pad, *real_c in cases:
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
            for out_dtype, tag in epilogues:
                def fn(x=x, w=w, m=m, bq=bq, s=stride, p=pad, o=out_dtype):
                    return k.int8_conv(x, w, m, bq, s, p, o)

                def plain(x=x, w=w, m=m, bq=bq, s=stride, p=pad,
                          o=out_dtype):
                    return k.int8_conv_plain(x, w, m, bq, s, p, o)

                got = fn()
                record(name, f"{label}/{tag}", got, plain(), fn, plain,
                       conv_work(x, w, got, *real_c), library)
                if real_c:
                    padded, _ = conv_work(x, w, got)
                    print(f"kernel {name}[{label}/{tag}]: the bound counts "
                          f"the C = {real_c[0]} channels that carry data; "
                          f"over the {C} the kernel reads it would be "
                          f"{padded:.3f} ms", flush=True)

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

    # K1's bf16 epilogue at the per-layer int8 BNInception's geometries
    # (--int8_mode perlayer): the stem conv, whose RGB input is quantized
    # into 16 channels of which 13 are zero, as are the weights' (signed:
    # normalized pixels), conv2_3x3, an unfused entry 1x1 and the 5b 1x1
    stem_x = act(SLICE_N, 224, 224, 16, lo=-127)
    stem_x[..., 3:] = 0
    stem_w = weights(64, 7, 7, 16)
    stem_w[..., 3:] = 0
    check_convs("int8_conv/perlayer", [
        ("stem_7x7_s2_p3_C3_in_16", stem_x, stem_w, 2, 3, 3),
        ("conv2_3x3", act(SLICE_N, 56, 56, 64), weights(192, 3, 3, 64), 1, 1),
        ("3a_1x1", act(SLICE_N, 28, 28, 192), weights(64, 1, 1, 192), 1, 0),
        ("5b_1x1", act(SLICE_N, 7, 7, 1024), weights(352, 1, 1, 1024), 1, 0),
    ], epilogues=((torch.bfloat16, "bf16"),))
    del stem_x, stem_w
    torch.cuda.empty_cache()

    # K1's requantizing epilogue at the all-int8 stems (hybrid_stem=False),
    # each conv at the shared stem's 128 frames (64 ticks and their flips;
    # BNInception 256x340, InceptionV3 341x452), BNInception's conv1 also
    # at 640 crops of 224^2: the input quantized from normalized pixels
    # (signed) into 16 channels of which 3 are real, as are the weights';
    # the later stem convs on post-ReLU int8
    def stem_conv_inputs(n, h, w, O, k, stride, pad):
        x = act(n, h, w, 16, lo=-127)
        x[..., 3:] = 0
        wq = weights(O, k, k, 16)
        wq[..., 3:] = 0
        return x, wq, stride, pad, 3

    frames2 = 2 * 64
    for name, cases in (
            ("int8_conv/int8_stem", [
                ("conv1_7x7_s2_p3_frames_C3_in_16",
                 *stem_conv_inputs(frames2, 256, 340, 64, 7, 2, 3)),
                ("conv1_7x7_s2_p3_crops_C3_in_16",
                 *stem_conv_inputs(SLICE_N, 224, 224, 64, 7, 2, 3)),
                ("conv2_3x3_reduce_1x1", act(frames2, 64, 85, 64),
                 weights(64, 1, 1, 64), 1, 0),
                ("conv2_3x3", act(frames2, 64, 85, 64),
                 weights(192, 3, 3, 64), 1, 1)]),
            ("int8_conv/int8_stem_iv3", [
                ("Conv2d_1a_3x3_s2_valid_C3_in_16",
                 *stem_conv_inputs(frames2, 341, 452, 32, 3, 2, (0, 0))),
                ("Conv2d_2a_3x3_valid", act(frames2, 170, 225, 32),
                 weights(32, 3, 3, 32), 1, (0, 0)),
                ("Conv2d_2b_3x3_same", act(frames2, 168, 223, 32),
                 weights(64, 3, 3, 32), 1, (1, 1)),
                ("Conv2d_3b_1x1", act(frames2, 83, 111, 64),
                 weights(80, 1, 1, 64), 1, (0, 0)),
                ("Conv2d_4a_3x3_valid", act(frames2, 83, 111, 80),
                 weights(192, 3, 3, 80), 1, (0, 0))])):
        check_convs(name, cases, epilogues=((torch.int8, "i8"),))
        del cases
        torch.cuda.empty_cache()

    # K2 at the all-int8 stems' pools (post-ReLU int8 shifted to signed):
    # BNInception's two Caffe-ceil s2 pools at the shared stem's frames and
    # at 224^2 crops, InceptionV3's two VALID s2 pools likewise (299^2)
    for name, pads_of, shapes in (
            ("int8_max_pool/stem",
             lambda h, w: pool_pads(h, w, 3, 2, ceil=True),
             (("pool1_frames_ceil_s2", (frames2, 128, 170, 64)),
              ("pool2_frames_ceil_s2", (frames2, 64, 85, 192)),
              ("pool1_crops_ceil_s2", (SLICE_N, 112, 112, 64)),
              ("pool2_crops_ceil_s2", (SLICE_N, 56, 56, 192)))),
            ("int8_max_pool/stem_iv3", lambda h, w: ((0, 0), (0, 0)),
             (("pool1_frames_valid_s2", (frames2, 168, 223, 64)),
              ("pool2_frames_valid_s2", (frames2, 81, 109, 192)),
              ("pool1_crops_valid_s2", (SLICE_N, 147, 147, 64)),
              ("pool2_crops_valid_s2", (SLICE_N, 71, 71, 192))))):
        for label, shape in shapes:
            x = act(*shape) - 64
            check_max_pool(name, label, x, 2, pads_of(*shape[1:3]))
            del x
        torch.cuda.empty_cache()

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
    # step's 1,152 images, float32 (the trainer's dtype) and bfloat16
    # (--bf16), and of InceptionV3's four VALID pools at the InceptionV3
    # run's IV3_TRAIN_VIDEOS x 72 images (ResNet's and VGG's pools:
    # run_training_clis, once their runs' -b is known)
    bni = (("stem1_ceil_s2", (112, 64), 3, 2, pool_pads(112, 112, 3, 2, True)),
           ("stem2_ceil_s2", (56, 192), 3, 2, pool_pads(56, 56, 3, 2, True)),
           ("3c_ceil_s2", (28, 320), 3, 2, pool_pads(28, 28, 3, 2, True)),
           ("4e_ceil_s2", (14, 576), 3, 2, pool_pads(14, 14, 3, 2, True)),
           ("5b_s1_p1", (7, 1024), 3, 1, pool_pads(7, 7, 3, 1, pad=1)))
    valid = ((0, 0), (0, 0))
    iv3 = (("iv3_pool1_147", (147, 64), 3, 2, valid),
           ("iv3_pool2_71", (71, 192), 3, 2, valid),
           ("iv3_6a_35", (35, 288), 3, 2, valid),
           ("iv3_7a_17", (17, 768), 3, 2, valid))
    check_a1(rows, card, both_dtypes(bni, TRAIN_N)
             + [b + (torch.float32, IV3_TRAIN_VIDEOS * 72) for b in iv3])
    torch.cuda.empty_cache()
    return rows


def write_fixture(d: str, n_videos: int = 2, frames=1560,
                  split: str = "thumos14_tag_test",
                  num_class: int = 20) -> str:
    """A proposal list (the repo's test-fixture format) with fg, incomplete
    and background proposals per video; ``frames`` is every video's frame
    count, or a list of them (one video each, the proposals of a
    1,560-frame video scaled to its length)."""
    lengths = ([frames] * n_videos if isinstance(frames, int)
               else list(frames))
    lines = []
    for v, n in enumerate(lengths):
        def at(f, n=n):
            return round(f * n / 1560)

        gt = [(1 + v % num_class, at(260), at(780)),
              (1 + (v + 7) % num_class, at(1040), at(1352))]
        props = []
        for g in gt:
            props += [(g[0], 0.85, 0.9, g[1] - at(52), g[2] + at(13)),
                      (g[0], 0.75, 0.95, g[1] + at(13), g[2] - at(39)),
                      (g[0], 0.2, 0.9, g[1] + at(78), g[1] + at(286)),
                      (g[0], 0.15, 0.85, g[1] + at(130), g[1] + at(338))]
        props += [(0, 0.0, 0.0, at(1378), at(1547)),
                  (0, 0.005, 0.0, at(26), at(234))]
        vid = f"video_{split.rsplit('_', 1)[-1]}_{v:07d}"
        lines.append(f"# {v}\n{vid}\n{n}\n1\n{len(gt)}\n")
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
    read just after; every kernel in ``expect`` must have launched. Returns
    the counts, with the path's wall seconds under ``"wall_s"``."""
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
    return dict(launches, wall_s=wall)


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


def main_path(card: str, smi: str, rows: dict, profile: str = None) -> dict:
    """Phases 4 and 5: the main paths at full width, then the checks and
    the timings (``rows``: the kernel rows, which the training phase
    extends). Returns each path's launch counts."""
    import torch

    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.train import float32_convs_and_matmuls

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
                 4),
                ("bninception_rgbdiff", "thumos14", "BNInception", "RGBDiff",
                 20, 7),
                ("resnet101_rgb", "thumos14", "resnet101", "RGB", 20, 5),
                ("vgg16_rgb", "thumos14", "vgg16", "RGB", 20, 6)):
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
        # the training step's float32, set here as the training CLIs set it
        float32_convs_and_matmuls()
        train = {}
        paths["train"] = drive(
            f"train ({TRAIN_STEPS} steps)",
            lambda: train.update(run_training(d)), ("max_pool_bwd",))
        paths.update(run_pool_modes(d, smi))
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
        paths.update(run_scoring_surface(d, clis))
        paths.update(run_int8_stem(d, models, smi))
        run_quantization_report(smi)
        for key, arch in (("resnet101_rgb", "resnet101"),
                          ("vgg16_rgb", "vgg16")):
            # float32 backbones: no int8 path, so no kernel to launch
            cli, out, K = clis[key]
            paths[key] = drive(f"ssn_test thumos14 RGB --arch {arch}",
                               lambda cli=cli: ssn_test(cli), ())
            print(f"main path: pickle ok (P={check_pickle(out, K)})",
                  flush=True)
            time_float_step(models.pop(key), smi)
        paths.update(run_checkpoints(d, smi))
        paths["binary_test"] = run_pipeline(d, smi)
        paths.update(run_training_clis(d, smi, rows))
        paths.update(run_data_parallel(d, smi))
        t0 = time.perf_counter()
        check_decoder(d, smi)
        paths.update(run_real_frames(d, smi))
        run_orbax(d)
        print(f"timing: the decoder, real-frame and orbax phases "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        paths.update(run_recipe(d, smi))
        print(f"timing: the recipe phase {time.perf_counter() - t0:.1f} s",
              flush=True)

        check_train_step_small(d)
        if profile:
            profile_cli(profile, "ssn_test", clis["bninception_rgb"][0])
            profile_cli(profile, "ssn_test_iv3", clis["inceptionv3_rgb"][0])

    scorers = [check_bninception(models["bninception_rgb"], smi),
               check_inceptionv3(models["inceptionv3_rgb"], smi),
               time_flow(models["bninception_flow"], smi),
               check_rgbdiff(models["bninception_rgbdiff"], smi),
               check_perlayer(models["bninception_rgb"], smi, profile)]
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
                                    "score_step_flow", "score_step_rgbdiff",
                                    "score_step_perlayer"), scorers):
            profile_calls(profile, name, step, reps=3)
        profile_calls(profile, "train_step", train_step, reps=2)
    for scorer, _ in scorers:
        scorer.close()
    return paths


def run_scoring_surface(d: str, clis: dict) -> dict:
    """Main path, part 4: the rest of the scoring CLI surface, each a path
    of its own on the 2 scoring videos: ``ssn_test thumos14 RGB --int8_mode
    perlayer`` (BNInception's RGB checkpoint; every conv on K1's bf16
    epilogue, its pools bf16 torch ops, so K2 and K3 must not launch),
    ``ssn_test thumos14 RGBDiff`` (the int8-e2e shared-stem default on
    15-channel differences; K1-K3), ``ssn_test thumos14 RGB --test_crops
    1`` (host center crops, int8-e2e per crop; K1-K3) and ``binary_test
    thumos14 RGB --host_crops`` (a seeded actionness BNInception, 10 host
    crops a tick, int8-e2e per crop; K1-K3). Each checks its pickle;
    returns each path's launches."""
    import numpy as np

    from action_detection_torch.cli.binary_test import main as binary_test
    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.models import BinaryClassifier, seeded_init
    from action_detection_torch.train import save_checkpoint

    k1_3 = ("int8_conv", "int8_max_pool", "int8_avg_pool")
    paths = {}
    cli, _, K = clis["bninception_rgb"]
    for key, name, argv, expect in (
            ("bninception_perlayer", "ssn_test thumos14 RGB --int8_mode "
             "perlayer (BNInception)", cli + ["--int8_mode", "perlayer"],
             ("int8_conv",)),
            ("bninception_rgbdiff", "ssn_test thumos14 RGBDiff "
             "(BNInception)", clis["bninception_rgbdiff"][0], k1_3),
            ("bninception_crops1", "ssn_test thumos14 RGB --test_crops 1 "
             "(BNInception)", cli + ["--test_crops", "1"], k1_3)):
        out = os.path.join(d, f"{key}.pkl")
        argv = list(argv)
        argv[3] = out
        paths[key] = drive(name, lambda argv=argv: ssn_test(argv), expect)
        print(f"main path: pickle ok (P={check_pickle(out, K)})", flush=True)
    pl = paths["bninception_perlayer"]
    if pl["int8_max_pool"] or pl["int8_avg_pool"]:
        raise AssertionError("--int8_mode perlayer launched int8 pools: "
                             f"{pl}")

    write_fixture(d, split="thumos14_sw_test")
    model = seeded_init(BinaryClassifier(dropout=0.0), seed=8)
    ckpt = os.path.join(d, "binary_host_crops.pt")
    save_checkpoint(ckpt, model.state_dict(), None, arch="BNInception")
    act = os.path.join(d, "binary_host_crops.pkl")
    paths["binary_host_crops"] = drive(
        "binary_test thumos14 RGB --host_crops (BNInception)",
        lambda: binary_test(["thumos14", "RGB", "testing", ckpt, act,
                             "--synthetic_data", "--prop_file_dir", d,
                             "--host_crops"]), k1_3)
    with open(act, "rb") as f:
        scores = pickle.load(f)
    T = len(range(0, 1560 - 1, 5))
    if len(scores) != 2 or not all(a.shape == (T, 10, 2)
                                   and np.isfinite(a).all()
                                   for a in scores.values()):
        raise AssertionError("--host_crops pickle: " + str(
            {k: a.shape for k, a in scores.items()}))
    print(f"main path: --host_crops pickle ok ({T}, 10, 2) per video",
          flush=True)
    return paths


def time_float_step(model, smi) -> float:
    """Steady-state 640-crop scoring step of a float32 backbone (ResNet and
    VGG have no int8 path; TF32 off) on 64 ticks of 340x256 frames: CUDA
    events, median of 5."""
    import numpy as np
    import torch

    from action_detection_torch.infer.scorer import ProposalScorer

    frames = np.random.RandomState(0).randint(0, 256, size=(64, 256, 340, 3),
                                              dtype=np.uint8)
    scorer = ProposalScorer(model, model.input_spec,
                            reg_stats=np.asarray(REG_STATS, np.float32),
                            num_class=model.num_class, chunk_frames=64,
                            device="cuda", quantize=False)
    chunk = torch.as_tensor(frames).cuda()
    step = lambda: scorer._score_chunk(chunk, 64)      # noqa: E731
    if not torch.isfinite(step()).all():
        raise AssertionError(f"{model.arch}: non-finite scores")
    ms = _time_ms(step, reps=5, warmup=1)
    scorer.close()
    model.to("cpu")
    print(f"step: {model.arch} float32 {ms:.2f} ms per {SLICE_N}-crop step "
          f"= {SLICE_N / ms * 1e3:.0f} crops/s, TF32 off ({smi})", flush=True)
    return ms


def run_checkpoints(d: str, smi: str) -> dict:
    """Main path, part 4: one seeded BNInception SSN (THUMOS14 RGB) written
    three ways, as the port's ``.pt``, as the JAX package's
    ``checkpoint.msgpack`` (``train/flax_msgpack.py``'s writer on the flax
    trees of ``models/convert.py:jax_from_state_dict``) and as a reference
    ``.pth.tar`` (``module.`` keys, no ``num_batches_tracked``, numpy
    ``reg_stats``) under its published file name in a model cache;
    ``ssn_test`` scores each, and ``--use_reference`` with
    ``$ADT_MODEL_CACHE`` at that cache, each a path of its own (K1-K3
    must launch). The four pickles must be equal."""
    import numpy as np
    import torch

    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.config import get_reference_model_url
    from action_detection_torch.models import jax_from_state_dict
    from action_detection_torch.train import flax_msgpack

    c = os.path.join(d, "checkpoints")
    cache = os.path.join(c, "cache")
    os.makedirs(cache)
    model, pt = _seeded_checkpoint(c, "bni", 20, "BNInception", "RGB", 11)
    sd = model.state_dict()
    params, stats = jax_from_state_dict(sd, "BNInception")
    msgpack = os.path.join(c, "checkpoint.msgpack")
    with open(msgpack, "wb") as f:
        f.write(flax_msgpack.serialize({
            "epoch": np.int64(0), "arch": "BNInception",
            "best_loss": np.float64(np.inf),
            "reg_stats": np.asarray(REG_STATS), "params": params,
            "batch_stats": stats, "extra": {}}))
    url = get_reference_model_url("thumos14", "RGB", "ImageNet",
                                  "BNInception")
    pth = os.path.join(cache, url.rsplit("/", 1)[-1])
    torch.save({"epoch": 80, "arch": "BNInception", "best_loss": 0.5,
                "reg_stats": np.asarray(REG_STATS),
                "state_dict": {"module." + k: v for k, v in sd.items()
                               if not k.endswith("num_batches_tracked")}},
               pth)
    sizes = {n: os.path.getsize(p) / 2**20 for n, p in (
        ("pt", pt), ("msgpack", msgpack), ("pth.tar", pth))}
    paths, pickles = {}, {}
    old = os.environ.get("ADT_MODEL_CACHE")
    for name, weights, extra in (("pt", pt, []), ("msgpack", msgpack, []),
                                 ("pth.tar", pth, []),
                                 ("use_reference", "none.pt",
                                  ["--use_reference"])):
        out = os.path.join(c, f"{name}.pkl")
        os.environ["ADT_MODEL_CACHE"] = cache
        try:
            paths[f"ssn_test_{name}"] = drive(
                f"ssn_test thumos14 RGB on the {name} checkpoint",
                lambda: ssn_test(["thumos14", "RGB", weights, out,
                                  "--synthetic_data", "--prop_file_dir", d]
                                 + extra),
                ("int8_conv", "int8_max_pool", "int8_avg_pool"))
        finally:
            if old is None:
                os.environ.pop("ADT_MODEL_CACHE")
            else:
                os.environ["ADT_MODEL_CACHE"] = old
        check_pickle(out, 20)
        with open(out, "rb") as f:
            pickles[name] = pickle.load(f)
    ref = pickles["pt"]
    for name, got in pickles.items():
        if set(got) != set(ref) or not all(
                np.array_equal(a, b) for vid in ref
                for a, b in zip(got[vid], ref[vid])):
            raise AssertionError(f"the {name} checkpoint scores differently "
                                 "from the .pt")
    print(f"checkpoints: .pt {sizes['pt']:.1f} MiB, JAX msgpack "
          f"{sizes['msgpack']:.1f} MiB, reference .pth.tar "
          f"{sizes['pth.tar']:.1f} MiB and --use_reference give equal "
          f"pickles ({smi})", flush=True)
    return paths


def _train_report(name: str, stats, launches: dict, peak_gib: float,
                  smi: str, busy=None) -> None:
    """One line of a training CLI run's numbers."""
    share = ("" if busy is None else
             f"; under the profiler wall {busy[0]:.2f} s, device busy "
             f"{busy[1]:.2f} s = {busy[1] / busy[0]:.1%}")
    print(f"train {name}: CLI wall {launches['wall_s']:.2f} s; "
          f"{stats.summary()}; peak {peak_gib:.2f} GiB allocated; A1 launches "
          f"{launches['max_pool_bwd']} (bf16 {launches['max_pool_bwd/bf16']})"
          f"{share} ({smi})", flush=True)


def train_memory(arch: str, dataset: str, size: int, smi: str) -> dict:
    """The largest -b (videos of 8 proposals x 9 segments of ``size^2``)
    whose ``arch`` SSN training step fits the card, without and with
    ``--remat``: one forward + backward on a device-made batch (no host
    work) for each -b tried. ``max_memory_allocated`` at -b 1 and 2 give a
    line; until a -b runs out of memory, the next -b is where the line
    through the last two that fit reaches the card's memory (at most 8x the
    largest that fits; twice it where the line does not rise), then a
    bisection between the largest -b that fits and the smallest that does
    not. With ``--remat`` the search starts from the largest -b without it.
    Peak allocated and reserved memory and each probe's time are printed.
    Returns ``{remat: (largest b, its peak bytes)}``."""
    import torch

    from action_detection_torch.config import get_configs
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.train import make_loss_fn

    cfg = get_configs(dataset)
    total = torch.cuda.get_device_properties(0).total_memory
    g = torch.Generator(device="cuda").manual_seed(9)
    labels = torch.tensor([5] + [7] * 6 + [0], device="cuda")
    out = {}
    for remat in (False, True):
        model = seeded_init(SSN(num_class=cfg.num_class, base_model=arch,
                                stpp_cfg=cfg.stpp, remat=remat),
                            seed=7).cuda()
        loss_fn = make_loss_fn(model, cfg.sampling)
        reserved, probes = {}, []

        def peak(b):
            t = time.perf_counter()
            got = _peak(b)
            probes.append(f"-b {b} " + (f"{got / 2**30:.1f} GiB" if got
                                        else "out of memory")
                          + f" {time.perf_counter() - t:.1f} s")
            return got

        def _peak(b):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                batch = {"frames": torch.randint(
                    0, 256, (8 * b, 9, size, size, 3), generator=g,
                    device="cuda", dtype=torch.uint8),
                    "scaling": torch.ones(8 * b, 2, device="cuda"),
                    "labels": labels.repeat(b),
                    "reg_targets": torch.zeros(8 * b, 2, device="cuda")}
                loss, _ = loss_fn(batch, True)
                loss.backward()
                torch.cuda.synchronize()
                reserved[b] = torch.cuda.max_memory_reserved()
                return torch.cuda.max_memory_allocated()
            except torch.cuda.OutOfMemoryError:
                return None
            finally:
                batch = loss = None
                model.zero_grad(set_to_none=True)

        t0 = time.perf_counter()
        p1, p2 = peak(1), peak(2)
        fit = {1: p1, 2: p2}
        lo, hi = 2, None        # the largest -b that fits, the smallest not
        if remat:               # recomputing never needs more memory
            lo = max(lo, out[False][0])
        while hi is None or hi - lo > 1:
            if hi is None:
                (b1, q1), (b2, q2) = sorted(fit.items())[-2:]
                slope = (q2 - q1) / (b2 - b1)
                b = (b2 + int((total - q2) // slope) if slope > 0
                     else 2 * b2)
                b = min(max(b, lo + 1), 8 * lo)
            else:
                b = (lo + hi) // 2
            got = peak(b)
            if got is None:
                hi = b
            else:
                lo, fit[b] = b, got
        if lo not in fit:
            fit[lo] = peak(lo)
            if fit[lo] is None:
                raise AssertionError(f"{arch}: -b {lo} fits without --remat "
                                     "but not with it")
        b, fits = lo, fit[lo]
        out[remat] = (b, fits)
        print(f"memory: {arch} training {'with' if remat else 'without'}"
              f" --remat: -b 1 {p1 / 2**30:.2f} GiB, -b 2 {p2 / 2**30:.2f} "
              f"GiB; largest -b that fits {b} ({8 * 9 * b} images, peak "
              f"{fits / 2**30:.2f} GiB allocated, "
              f"{reserved[b] / 2**30:.2f} GiB reserved, of "
              f"{total / 2**30:.2f}), -b {b + 1} runs out of memory; "
              f"{len(probes)} probes in {time.perf_counter() - t0:.1f} s: "
              f"{', '.join(probes)} ({smi})", flush=True)
        del model
        torch.cuda.empty_cache()
    return out


def run_training_clis(d: str, smi: str, rows: dict) -> dict:
    """Main path, part 6: the training CLIs in process on synthetic frames,
    each a path of its own (launch counts set to 0 before, A1 required
    after): ``ssn_train thumos14 RGB`` BNInception at the recipe batch (-b
    16: 1,152 images a step), one epoch of 3 steps, validation and a
    checkpoint; ``--resume`` from it for one more epoch under the profiler
    (it must start at the saved epoch, LR decayed by ``--lr_steps 1 2``);
    the port's ``ssn_test`` scoring the trained checkpoint; ``--iter_size
    2`` (2 mini-steps, 1 update); ``--bf16`` (A1 in bf16); Flow from the
    RGB checkpoint
    (``--init_weights``, the 10-channel cross-modality conv1); RGBDiff from
    it (-b 4, the 15-channel conv1; 2 steps) with ``ssn_test`` on its
    checkpoint; InceptionV3
    on ActivityNet v1.2 at ``IV3_TRAIN_VIDEOS`` (after ``train_memory``);
    ``binary_train`` (-b 4: 240 images) with ``binary_test`` on its
    checkpoint; and ResNet-101 and VGG-16: ``train_memory``, A1 at their
    pools (``check_a1``, rows added to ``rows``) at the images of the
    largest -b of ``RECIPE_BATCHES`` below the largest that fits without
    ``--remat`` (a video of headroom), then
    ``ssn_train`` at that -b, float32 and ``--bf16`` (A1 required, in bf16
    alone under ``--bf16``). Returns each run's launches."""
    import contextlib

    import numpy as np
    import torch

    from action_detection_torch.cli.binary_test import main as binary_test
    from action_detection_torch.cli.binary_train import main as binary_train
    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.cli.ssn_train import main as ssn_train
    from action_detection_torch.train import load_checkpoint

    t = os.path.join(d, "train")
    os.makedirs(t)
    write_fixture(t, n_videos=TRAIN_LIST_VIDEOS, split="thumos14_tag_val")
    write_fixture(t, split="thumos14_tag_test")
    write_fixture(t, n_videos=TRAIN_LIST_VIDEOS,
                  split="activitynet1.2_tag_train", num_class=100)
    write_fixture(t, split="activitynet1.2_tag_val", num_class=100)
    write_fixture(t, n_videos=12, split="thumos14_sw_val")
    write_fixture(t, split="thumos14_sw_test")
    common = ["--synthetic_data", "--prop_file_dir", t, "--print-freq", "1",
              "--clip-gradient", "20", "--lr_steps", "1", "2"]
    rgb = ["thumos14", "RGB", *common, "-b", str(TRAIN_VIDEOS)]
    ckpt = os.path.join(t, "ssn_thumos14_BNInception_rgb_checkpoint.pt")
    paths = {}

    def tem(steps: int, videos: int) -> list:
        """--tem giving ``steps`` steps an epoch at -b ``videos``."""
        return ["--tem", str(steps * videos // TRAIN_LIST_VIDEOS)]

    def run(key, name, cli, argv, expect=("max_pool_bwd",), profile=False):
        out = {}
        torch.cuda.reset_peak_memory_stats()

        def call():
            out["stats"] = cli(argv)

        fn = ((lambda: out.update(busy=profiled_run(call)[1:])) if profile
              else call)
        paths[key] = drive(name, fn, expect)
        _train_report(name, out["stats"], paths[key],
                      torch.cuda.max_memory_allocated() / 2**30, smi,
                      out.get("busy"))
        return out["stats"]

    def expect(cond, what):
        if not cond:
            raise AssertionError(what)

    with contextlib.chdir(t):
        st = run("train_cli", "ssn_train thumos14 RGB (BNInception, -b 16)",
                 ssn_train, rgb + tem(3, TRAIN_VIDEOS) + ["--epochs", "1"])
        expect(len(st.step_ms) == 3 and st.images == TRAIN_N
               and np.isfinite(st.best_loss)
               and load_checkpoint(ckpt)["epoch"] == 1,
               f"ssn_train RGB: {len(st.step_ms)} steps of {st.images}, "
               f"best loss {st.best_loss}")
        st = run("train_cli_resume", "ssn_train thumos14 RGB --resume",
                 ssn_train, rgb + tem(3, TRAIN_VIDEOS) + [
                     "--epochs", "2", "--resume", ckpt], profile=True)
        expect(len(st.step_ms) == 3 and st.lr_factor == 0.1
               and load_checkpoint(ckpt)["epoch"] == 2,
               f"resume: {len(st.step_ms)} steps at LR x{st.lr_factor}")
        print(f"train: the resumed run started at epoch 1 with the LR x "
              f"{st.lr_factor} (lr_steps 1 2), best loss {st.best_loss:.5f}",
              flush=True)
        scores = os.path.join(t, "trained.pkl")
        paths["ssn_test_trained"] = drive(
            "ssn_test thumos14 RGB on the trained checkpoint",
            lambda: ssn_test(["thumos14", "RGB", ckpt, scores,
                              "--synthetic_data", "--prop_file_dir", t]),
            ("int8_conv", "int8_max_pool", "int8_avg_pool"))
        print(f"train: trained checkpoint scored, pickle ok "
              f"(P={check_pickle(scores, 20)})", flush=True)
        st = run("train_cli_iter2", "ssn_train thumos14 RGB --iter_size 2",
                 ssn_train, rgb + tem(2, TRAIN_VIDEOS) + [
                     "--epochs", "1", "--iter_size", "2",
                     "--snapshot_pref", "_iter2"])
        expect(len(st.step_ms) == 2 and st.updates == 1,
               f"--iter_size 2: {len(st.step_ms)} steps, {st.updates} "
               "updates")
        st = run("train_cli_bf16", "ssn_train thumos14 RGB --bf16",
                 ssn_train, rgb + tem(2, TRAIN_VIDEOS) + [
                     "--epochs", "1", "--bf16", "--snapshot_pref", "_bf16"],
                 expect=("max_pool_bwd", "max_pool_bwd/bf16"))
        a1 = paths["train_cli_bf16"]
        expect(a1["max_pool_bwd/bf16"] == a1["max_pool_bwd"],
               f"--bf16: A1 launches {a1['max_pool_bwd']}, of them bf16 "
               f"{a1['max_pool_bwd/bf16']}")
        print("train: --bf16 ran every A1 launch in torch.bfloat16 "
              f"({a1['max_pool_bwd/bf16']} of {a1['max_pool_bwd']})",
              flush=True)
        st = run("train_cli_flow", "ssn_train thumos14 Flow --init_weights "
                 "<RGB checkpoint>", ssn_train,
                 ["thumos14", "Flow", *common, "-b", str(FLOW_TRAIN_VIDEOS),
                  *tem(2, FLOW_TRAIN_VIDEOS), "--epochs", "1",
                  "--init_weights", ckpt])
        flow = load_checkpoint(os.path.join(
            t, "ssn_thumos14_BNInception_flow_checkpoint.pt"))
        expect(len(st.step_ms) == 2 and flow["state_dict"][
            "base_model.conv1_7x7_s2.weight"].shape[1] == 10,
            f"Flow: {len(st.step_ms)} steps")
        st = run("train_cli_rgbdiff", "ssn_train thumos14 RGBDiff "
                 "--init_weights <RGB checkpoint>", ssn_train,
                 ["thumos14", "RGBDiff", *common, "-b",
                  str(RGBDIFF_TRAIN_VIDEOS), *tem(2, RGBDIFF_TRAIN_VIDEOS),
                  "--epochs", "1", "--init_weights", ckpt])
        diff_ckpt = os.path.join(
            t, "ssn_thumos14_BNInception_rgbdiff_checkpoint.pt")
        expect(len(st.step_ms) == 2
               and st.images == RGBDIFF_TRAIN_VIDEOS * 72
               and load_checkpoint(diff_ckpt)["state_dict"][
                   "base_model.conv1_7x7_s2.weight"].shape[1] == 15,
               f"RGBDiff: {len(st.step_ms)} steps of {st.images}")
        scores = os.path.join(t, "trained_rgbdiff.pkl")
        paths["ssn_test_trained_rgbdiff"] = drive(
            "ssn_test thumos14 RGBDiff on the trained checkpoint (1 video)",
            lambda: ssn_test(["thumos14", "RGBDiff", diff_ckpt, scores,
                              "--synthetic_data", "--prop_file_dir", t,
                              "--max_num", "1"]),
            ("int8_conv", "int8_max_pool", "int8_avg_pool"))
        print(f"train: trained RGBDiff checkpoint scored, pickle ok "
              f"(P={check_pickle(scores, 20, n_videos=1)})", flush=True)
        mem = train_memory("InceptionV3", "activitynet1.2", 299, smi)
        expect(IV3_TRAIN_VIDEOS < mem[False][0],
               f"-b {IV3_TRAIN_VIDEOS} leaves no headroom under "
               f"{mem[False][0]}")
        st = run("train_cli_iv3", "ssn_train activitynet1.2 RGB --arch "
                 f"InceptionV3 (-b {IV3_TRAIN_VIDEOS})", ssn_train,
                 ["activitynet1.2", "RGB", *common, "--arch", "InceptionV3",
                  "-b", str(IV3_TRAIN_VIDEOS), *tem(2, IV3_TRAIN_VIDEOS),
                  "--epochs", "1"])
        expect(len(st.step_ms) == 2 and st.images == IV3_TRAIN_VIDEOS * 72,
               f"InceptionV3: {len(st.step_ms)} steps of {st.images}")
        st = run("train_cli_binary", "binary_train thumos14 RGB "
                 "(BNInception, -b 4)", binary_train,
                 ["thumos14", "RGB", *common, "--epochs", "1"])
        expect(len(st.step_ms) == 3 and st.images == 240,
               f"binary_train: {len(st.step_ms)} steps of {st.images}")
        act = os.path.join(t, "trained_actionness.pkl")
        paths["binary_test_trained"] = drive(
            "binary_test thumos14 RGB on the trained checkpoint",
            lambda: binary_test(["thumos14", "RGB", "testing", os.path.join(
                t, "ssn_thumos14_BNInception_rgb_binary_checkpoint.pt"),
                act, "--synthetic_data", "--prop_file_dir", t]),
            ("int8_conv", "int8_max_pool", "int8_avg_pool"))
        with open(act, "rb") as f:
            a = pickle.load(f)
        expect(len(a) == 2 and all(v.shape[1:] == (10, 2)
                                   and np.isfinite(v).all()
                                   for v in a.values()),
               "binary_test on the trained checkpoint: " + str(
                   {k: v.shape for k, v in a.items()}))
        print("train: binary checkpoint scored by binary_test, (T, 10, 2) "
              "per video", flush=True)
        valid = ((0, 0), (0, 0))
        pools = {"resnet101": (("resnet_stem_s2_p1", (112, 64), 3, 2,
                                ((1, 1), (1, 1))),),
                 "vgg16": tuple((f"vgg16_pool{i + 1}_{hw}", (hw, c), 2, 2,
                                 valid)
                                for i, (hw, c) in enumerate(
                                    ((224, 64), (112, 128), (56, 256),
                                     (28, 512), (14, 512))))}
        for arch in ("resnet101", "vgg16"):
            mem = train_memory(arch, "thumos14", 224, smi)
            # a video of headroom: at the edge, whether a -b fits depends
            # on the allocator's state (VGG-16's largest -b came out 14, 15
            # and 16 in three runs on one H100 80GB)
            videos = max([b for b in RECIPE_BATCHES if b < mem[False][0]],
                         default=0)
            expect(videos > 0, f"{arch}: -b {RECIPE_BATCHES[0]} leaves no "
                   f"headroom (largest -b {mem[False][0]})")
            print(f"train: {arch} runs at -b {videos}, the largest of "
                  f"{RECIPE_BATCHES} below the largest that fits without "
                  "--remat", flush=True)
            check_a1(rows, torch.cuda.get_device_name(0),
                     both_dtypes(pools[arch], videos * 72), seed=1)
            for bf16 in (False, True):
                tag = "/bf16" if bf16 else ""
                st = run(f"train_cli_{arch}{tag}",
                         f"ssn_train thumos14 RGB --arch {arch} (-b {videos})"
                         f"{' --bf16' if bf16 else ''}", ssn_train,
                         rgb[:-2] + ["-b", str(videos), "--arch", arch,
                                     *tem(2, videos), "--epochs", "1",
                                     "--snapshot_pref", f"_{arch}{tag[1:]}"]
                         + (["--bf16"] if bf16 else []),
                         expect=("max_pool_bwd",) + (("max_pool_bwd/bf16",)
                                                     if bf16 else ()))
                expect(len(st.step_ms) == 2 and st.images == videos * 72
                       and np.isfinite(st.best_loss),
                       f"{arch}{tag}: {len(st.step_ms)} steps of "
                       f"{st.images}, best loss {st.best_loss}")
                a1 = paths[f"train_cli_{arch}{tag}"]
                expect(not bf16 or a1["max_pool_bwd/bf16"]
                       == a1["max_pool_bwd"], f"{arch} --bf16: A1 launches "
                       f"{a1['max_pool_bwd']}, of them bf16 "
                       f"{a1['max_pool_bwd/bf16']}")
    return paths


class _Tee:
    """A stdout that also keeps what was written (``tee_stdout``)."""

    def __init__(self, out):
        import io

        self.out, self.buf = out, io.StringIO()

    def write(self, s: str) -> int:
        self.out.write(s)
        return self.buf.write(s)

    def flush(self) -> None:
        self.out.flush()


def tee_stdout(fn) -> str:
    """``fn()`` with its output printed as usual; returns the output."""
    import contextlib

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        fn()
    return tee.buf.getvalue()


def _max_abs_delta(a: dict, b: dict) -> float:
    """The largest |a - b| over two score pickles (``{video: array}`` or
    ``{video: tuple of arrays}``); inf where videos or shapes differ."""
    import numpy as np

    if set(a) != set(b):
        return float("inf")
    worst = 0.0
    for vid in a:
        xs, ys = a[vid], b[vid]
        if isinstance(xs, np.ndarray):
            xs, ys = [xs], [ys]
        for x, y in zip(xs, ys):
            if x is None or y is None:
                if x is not y:
                    return float("inf")
                continue
            if x.shape != y.shape:
                return float("inf")
            if x.size:
                worst = max(worst, float(np.abs(x.astype(np.float64)
                                                - y).max()))
    return worst


def run_data_parallel(d: str, smi: str) -> dict:
    """Main path, part 7: the data-parallel paths, each its own path
    (launch counts set to 0 before, K1-K3 or A1 required after), in
    ``d/parallel``: ``ssn_test --pack`` against ``--no_pack`` on four
    videos of unequal length (``PACK_FRAMES``; equal pickles, fewer padded
    ticks); ``score_videos`` over ``[cuda:0, cuda:0]`` (two threads, two
    scorers, one card, int8-e2e calibrated lazily on the first chunk)
    against one device; ``binary_test``'s queue (``score_actionness``)
    likewise; two DDP ranks on the card on gloo at -b ``DDP_VIDEOS`` each
    against one rank at twice that on the same global batches
    (``ddp_two_ranks``); and ``ssn_train`` through the multi-host flags on
    NCCL against the CLI without a process group, its checkpoint scored by
    ``ssn_test``. Returns each path's launches."""
    import contextlib
    import re

    import numpy as np

    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.config import get_configs
    from action_detection_torch.data.binary_dataset import BinaryDataset
    from action_detection_torch.data.pipeline import (
        SyntheticFrameProvider, collect_calibration_frames,
        make_test_transform)
    from action_detection_torch.data.ssn_dataset import SSNDataset
    from action_detection_torch.infer.actionness import (ActionnessScorer,
                                                         score_actionness)
    from action_detection_torch.infer.features import shared_prequantized
    from action_detection_torch.infer.scorer import (ProposalScorer,
                                                     score_videos)
    from action_detection_torch.models import BinaryClassifier, seeded_init

    t_start = time.perf_counter()
    k1_3 = ("int8_conv", "int8_max_pool", "int8_avg_pool")
    p = os.path.join(d, "parallel")
    os.makedirs(p)
    write_fixture(p, frames=PACK_FRAMES)
    write_fixture(p, frames=PACK_FRAMES, split="thumos14_sw_test")
    n_videos = len(PACK_FRAMES)
    ckpt = os.path.join(d, "bninception_rgb.pt")
    paths, pickles, ticks, walls = {}, {}, {}, {}
    # in turns, so neither mode alone pays a first run's warm-up
    for mode in ("--pack", "--no_pack", "--no_pack", "--pack"):
        out = os.path.join(p, f"{mode[2:]}.pkl")
        text = {}
        argv = ["thumos14", "RGB", ckpt, out, "--synthetic_data",
                "--prop_file_dir", p, mode]
        paths[f"ssn_test{mode}"] = drive(
            f"ssn_test thumos14 RGB {mode} ({n_videos} videos of "
            f"{'/'.join(map(str, PACK_FRAMES))} frames)",
            lambda argv=argv: text.update(out=tee_stdout(
                lambda: ssn_test(argv))), k1_3)
        m = re.search(r"(\d+) ticks scored on the device for (\d+) frame "
                      r"ticks", text["out"])
        ticks[mode] = (int(m.group(1)), int(m.group(2)))
        walls.setdefault(mode, []).append(
            paths[f"ssn_test{mode}"]["wall_s"])
        check_pickle(out, 20, n_videos)
        with open(out, "rb") as f:
            pickles[mode] = pickle.load(f)
    delta = _max_abs_delta(pickles["--pack"], pickles["--no_pack"])
    (pk, real), (nk, _) = ticks["--pack"], ticks["--no_pack"]
    pw, nw = (", ".join(f"{w:.2f}" for w in walls[m])
              for m in ("--pack", "--no_pack"))
    print(f"pack: --pack walls {pw} s, {pk} ticks on the device "
          f"({pk - real} padding); --no_pack walls {nw} s, {nk} ticks "
          f"({nk - real} padding), for {real} frame ticks; pickles max "
          f"|d| {delta}; K1/K2/K3 launches --pack "
          + "/".join(str(paths["ssn_test--pack"][k]) for k in k1_3)
          + " --no_pack "
          + "/".join(str(paths["ssn_test--no_pack"][k]) for k in k1_3)
          + f" ({smi})", flush=True)
    if delta != 0.0 or not pk < nk:
        raise AssertionError(f"--pack: max |d| {delta} against --no_pack, "
                             f"{pk} vs {nk} device ticks")

    # the fan-out: two scorers, two threads, one card
    cfg = get_configs("thumos14")
    model, _ = _seeded_checkpoint(p, "fanout", 20, "BNInception", "RGB",
                                  seed=0)
    ds = SSNDataset(os.path.join(p, "thumos14_tag_test_proposal_list.txt"),
                    cfg.sampling, test_interval=6)
    provider = SyntheticFrameProvider()

    def proposal_scorer(device):
        return ProposalScorer(model, model.input_spec, reg_stats=REG_STATS,
                              num_class=20, stpp_cfg=cfg.stpp,
                              chunk_frames=64, device=device,
                              quantize="e2e", shared_stem=True)

    runs = {}
    for devices in (["cuda:0"], ["cuda:0", "cuda:0"]):
        key = f"score_videos x{len(devices)}"
        paths[key] = drive(
            f"score_videos over {devices} (lazy int8 calibration)",
            lambda devices=devices, key=key: runs.update({key: {
                v: r.as_tuple() for v, r in score_videos(
                    proposal_scorer, ds, provider,
                    devices=devices).items()}}), k1_3)
    delta = _max_abs_delta(runs["score_videos x1"], runs["score_videos x2"])
    print(f"fan-out: score_videos wall one device "
          f"{paths['score_videos x1']['wall_s']:.2f} s, two scorers on "
          f"[cuda:0, cuda:0] {paths['score_videos x2']['wall_s']:.2f} s; "
          f"pickles max |d| {delta} ({smi})", flush=True)
    if delta != 0.0:
        raise AssertionError(f"fan-out: max |d| {delta} against one device")

    binary = seeded_init(BinaryClassifier(dropout=0.0), seed=8)
    bds = BinaryDataset(os.path.join(p, "thumos14_sw_test_proposal_list.txt"),
                        new_length=1, test_interval=5)
    spec = binary.input_spec
    calib = collect_calibration_frames(
        bds, provider, make_test_transform(spec.input_size, spec.scale_size,
                                           10), new_length=1)

    def make_actionness(device, prequantized):
        return ActionnessScorer(binary, spec, device=device, quantize="e2e",
                                calibration_frames=calib, shared_stem=True,
                                prequantized=prequantized)

    for devices in (["cuda:0"], ["cuda:0", "cuda:0"]):
        key = f"binary_queue x{len(devices)}"
        paths[key] = drive(
            f"binary_test queue over {devices}",
            lambda devices=devices, key=key: runs.update({key: (
                score_actionness(shared_prequantized(make_actionness, True),
                                 bds, provider, devices=devices))}), k1_3)
    delta = _max_abs_delta(runs["binary_queue x1"], runs["binary_queue x2"])
    print(f"fan-out: binary_test queue wall one device "
          f"{paths['binary_queue x1']['wall_s']:.2f} s, [cuda:0, cuda:0] "
          f"{paths['binary_queue x2']['wall_s']:.2f} s; pickles max |d| "
          f"{delta} ({smi})", flush=True)
    if delta != 0.0 or len(runs["binary_queue x2"]) != n_videos:
        raise AssertionError(f"binary queue: max |d| {delta}")

    paths.update(ddp_two_ranks(d, p, smi))
    with contextlib.chdir(os.path.join(d, "train")):
        paths.update(ddp_cli(d, smi))
    print(f"timing: the data-parallel phases {time.perf_counter() - t_start:.1f}"
          " s", flush=True)
    return paths


def write_lossless_frames(directory: str) -> dict:
    """The 8 committed 340x256 RGB JPEG frames' decoded pixels re-encoded
    losslessly under ``directory``, as ``img_0000k.jpg`` (the CLIs' frame
    name): frames 1 and 2 a PNG with a filter chosen a row, 3 and 4 an
    Adam7 PNG, 5 and 6 a 24-bit BMP, 7 and 8 a binary PPM (so the odd
    frames a scoring run reads, 6 frames apart, hold all four). Returns
    each format's files."""
    from action_detection_torch.data.jpeg import decode_jpeg

    from tests.frame_encoders import bmp_bytes, png_rgb, ppm_rgb

    encoders = (("png", png_rgb), ("png_adam7",
                                   lambda a: png_rgb(a, interlace=True)),
                ("bmp", lambda a: bmp_bytes(a, 24)), ("ppm", ppm_rgb))
    os.makedirs(directory)
    files = {name: [] for name, _ in encoders}
    for k in range(1, JPEG_FIXTURE_FRAMES + 1):
        rgb = decode_jpeg(os.path.join(JPEG_FIXTURES, f"img_{k:05d}.jpg"))
        name, encode = encoders[(k - 1) // 2]
        path = os.path.join(directory, f"img_{k:05d}.jpg")
        with open(path, "wb") as f:
            f.write(encode(rgb))
        files[name].append(path)
    return files


def check_digests(directory: str, decode) -> int:
    """Every file of ``directory/digests.json`` decoded by ``decode`` as
    RGB and as L to PIL's shape and sha256; returns the decodes made."""
    import hashlib

    with open(os.path.join(directory, "digests.json")) as f:
        digests = json.load(f)
    n = 0
    for name, modes in sorted(digests.items()):
        for mode, want in sorted(modes.items()):
            a = decode(os.path.join(directory, name), mode)
            got = {"shape": list(a.shape),
                   "sha256": hashlib.sha256(a.tobytes()).hexdigest()}
            if got != want:
                raise AssertionError(f"decoder: {name} as {mode}: {got}, "
                                     f"PIL's digest {want}")
            n += 1
    return n


def check_decoder(d: str, smi: str) -> None:
    """The host frame decoder (``data/image.py``, its JPEG half
    ``data/jpeg.py``): every committed JPEG fixture
    (``tests/fixtures/torch_port_jpeg``: baseline, progressive, arithmetic
    with DAC and restarts, CMYK and YCCK, the smoothed
    incomplete scripts, an arithmetic file past PIL's read block) and
    every PNG, BMP and PNM fixture (``tests/fixtures/torch_port_frames``)
    decoded as RGB and as L, each array's shape and sha256 equal to PIL's
    in ``digests.json``; then ms per 340x256 RGB frame (baseline, and the
    progressive, arithmetic and progressive arithmetic transcodes of the
    same frames; their pixels re-encoded as filtered and Adam7 PNGs, BMPs
    and PPMs, ``write_lossless_frames`` into ``d/lossless``, which
    ``run_real_frames`` scores) and per Flow x/y pair, 400 decodes each on
    one thread and on the scoring CLIs' default decode pool
    (``make_decode_pool(None)``), beside the synthetic provider's ms per
    RGB frame."""
    from concurrent.futures import ThreadPoolExecutor

    from action_detection_torch.data.image import build_decoder, decode_image
    from action_detection_torch.data.jpeg import decode_jpeg
    from action_detection_torch.data.pipeline import (SyntheticFrameProvider,
                                                      make_decode_pool)

    t0 = time.perf_counter()
    lib = build_decoder()
    print(f"build: {os.path.relpath(lib, ROOT)} (frame decoder) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    n = check_digests(JPEG_FIXTURES, decode_jpeg)
    print(f"decoder: {n} decodes of the committed JPEG fixtures (RGB and L) "
          "equal PIL's digests (shape and sha256)", flush=True)
    n = check_digests(FRAME_FIXTURES, decode_image)
    print(f"decoder: {n} decodes of the committed PNG, BMP and PNM "
          "fixtures (RGB and L) equal PIL's digests (shape and sha256)",
          flush=True)
    t0 = time.perf_counter()
    lossless = write_lossless_frames(os.path.join(d, "lossless"))
    print(f"decoder: the 8 JPEG frames re-encoded as PNG, Adam7 PNG, BMP "
          f"and PPM in {time.perf_counter() - t0:.1f} s", flush=True)

    frames = range(1, JPEG_FIXTURE_FRAMES + 1)
    rgb = [os.path.join(JPEG_FIXTURES, f"img_{i:05d}.jpg") for i in frames]
    tc = [os.path.join(JPEG_FIXTURES, f"tc_{i:05d}.jpg") for i in frames]
    flow = [tuple(os.path.join(JPEG_FIXTURES, f"{a}_{i:05d}.jpg")
                  for a in "xy") for i in frames]
    synthetic = SyntheticFrameProvider()
    pool = make_decode_pool(None) or ThreadPoolExecutor(1)

    def rgb_fn(path):
        return decode_jpeg(path, "RGB")

    def image_fn(path):
        return decode_image(path, "RGB")

    for name, fn, items in (
            ("RGB frame 340x256", rgb_fn, rgb),
            ("PNG RGB frame 340x256 (a filter chosen a row)", image_fn,
             lossless["png"]),
            ("PNG RGB frame 340x256 (Adam7)", image_fn,
             lossless["png_adam7"]),
            ("BMP RGB frame 340x256 (24-bit)", image_fn, lossless["bmp"]),
            ("PPM RGB frame 340x256 (P6)", image_fn, lossless["ppm"]),
            ("progressive RGB frame 340x256 (tc 1-4)", rgb_fn, tc[:4]),
            ("arithmetic RGB frame 340x256 (sequential, tc 5-6)", rgb_fn,
             tc[4:6]),
            ("arithmetic RGB frame 340x256 (progressive, tc 7-8)", rgb_fn,
             tc[6:]),
            ("Flow x/y pair 340x256",
             lambda xy: [decode_jpeg(p, "L") for p in xy], flow)):
        jobs = items * (400 // len(items))
        for j in items:
            fn(j)
        t0 = time.perf_counter()
        for j in jobs:
            fn(j)
        one = (time.perf_counter() - t0) / len(jobs) * 1e3
        t0 = time.perf_counter()
        list(pool.map(fn, jobs))
        many = (time.perf_counter() - t0) / len(jobs) * 1e3
        print(f"decoder: {name} {one:.3f} ms on 1 thread, {many:.3f} ms a "
              f"frame on {pool._max_workers} threads (the CLIs' default "
              f"decode pool; {os.cpu_count()} cores) ({smi})", flush=True)
    pool.shutdown()
    t0 = time.perf_counter()
    for i in range(400):
        synthetic.load("video", i)
    print(f"decoder: the synthetic provider draws a 340x256 RGB frame in "
          f"{(time.perf_counter() - t0) / 400 * 1e3:.3f} ms on 1 thread",
          flush=True)


def link_jpeg_frames(root: str, videos, frames: int,
                     rgb: str = "img", rgb_dir: str = JPEG_FIXTURES) -> None:
    """``root/<video>/img_*``, ``x_*`` and ``y_*`` for frames 1..frames:
    links cycling over the committed 340x256 fixtures, in one directory
    that every video's directory links to; ``rgb="tc"`` links the RGB
    frames to the coefficient-identical transcodes ``tc_*`` instead (1-4
    progressive Huffman, 5-8 arithmetic), frame for frame; ``rgb_dir``
    the directory of the RGB frames (``write_lossless_frames``'s)."""
    shared = os.path.join(root, ".frames")
    os.makedirs(shared)
    for i in range(1, frames + 1):
        k = (i - 1) % JPEG_FIXTURE_FRAMES + 1
        for src, dst in ((os.path.join(rgb_dir, f"{rgb}_{k:05d}.jpg"),
                          f"img_{i:05d}.jpg"),
                         (os.path.join(JPEG_FIXTURES, f"x_{k:05d}.jpg"),
                          f"x_{i:05d}.jpg"),
                         (os.path.join(JPEG_FIXTURES, f"y_{k:05d}.jpg"),
                          f"y_{i:05d}.jpg")):
            os.symlink(src, os.path.join(shared, dst))
    for v in videos:
        os.symlink(shared, os.path.join(root, v))


def run_real_frames(d: str, smi: str) -> dict:
    """Main path, part 8: the CLIs on JPEG frame directories
    (``--data_root``; THUMOS14 videos of 1,560 frames whose directories
    cycle over the committed fixtures), each a path of its own that must
    launch its kernels and the decoder: ``ssn_test`` BNInception RGB and
    Flow (the int8-e2e shared-stem default, the seeded checkpoints of part
    1), ``binary_test`` (part 5's checkpoint) and ``ssn_train`` BNInception
    RGB -b 16 (``REAL_TRAIN_STEPS`` steps and validation). In each run
    ``host_jpeg_decode`` must equal the frame files its loads read (one an
    RGB load, two a Flow load). Each is then run on synthetic frames
    (``--synthetic_data``, the same arguments), and both are run again
    under the profiler: the walls and device busy shares, side by side.
    ``ssn_train`` runs twice only, each under the profiler (the JPEG run
    is the counted one), with the host seconds a batch of each. Last,
    ``ssn_test`` BNInception RGB once more, on directories whose RGB frames
    link to the coefficient-identical transcodes of the same frames (1-4
    progressive Huffman, 5-8 arithmetic; ``link_jpeg_frames(rgb="tc")``):
    a path of its own that must launch K1-K3 and decode once a file read,
    and whose pickle must equal the baseline frames' byte for byte; and
    once more on directories whose ``img_*.jpg`` files hold the same
    pixels as PNG, Adam7 PNG, BMP and PPM files (``check_decoder``'s
    ``d/lossless``): K1-K3, one PNG, BMP or PNM decode a file read and no
    JPEG one, the same pickle byte for byte. Returns each path's
    launches."""
    import contextlib
    from unittest import mock

    import numpy as np

    from action_detection_torch.cli.binary_test import main as binary_test
    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.cli.ssn_train import main as ssn_train
    from action_detection_torch.data import pipeline
    from action_detection_torch.data.proposal_io import load_proposal_file

    real = os.path.join(d, "real")
    os.makedirs(real)
    frames = os.path.join(real, "frames")
    lists = [write_fixture(real), write_fixture(real,
                                                split="thumos14_sw_test"),
             write_fixture(real, n_videos=TRAIN_LIST_VIDEOS,
                           split="thumos14_tag_val")]
    videos = sorted({g[0] for p in lists for g in load_proposal_file(p)})
    t0 = time.perf_counter()
    link_jpeg_frames(frames, videos, PIPELINE_FRAMES)
    print(f"real frames: {len(videos)} videos of {PIPELINE_FRAMES} frames "
          f"(RGB, x, y) linked in {time.perf_counter() - t0:.1f} s",
          flush=True)
    k1_3 = ("int8_conv", "int8_max_pool", "int8_avg_pool")
    load = pipeline.DirectoryFrameProvider.load
    files = []

    def counted(self, video_id, idx):
        out = load(self, video_id, idx)
        files.append(len(out))
        return out

    stats = {}

    def cli_call(cli, argv, key):
        def call():
            res = cli(argv)
            if key:
                stats[key] = res
        return call

    paths = {}
    train = ["--print-freq", "1", "--clip-gradient", "20", "--lr_steps", "1",
             "2", "-b", str(TRAIN_VIDEOS), "--tem",
             str(REAL_TRAIN_STEPS * TRAIN_VIDEOS // TRAIN_LIST_VIDEOS),
             "--epochs", "1", "--snapshot_pref", "_real"]
    act = os.path.join(real, "actionness.pkl")
    runs = (
        ("real_ssn_test_rgb", "ssn_test thumos14 RGB (BNInception)",
         ssn_test, ["thumos14", "RGB", os.path.join(d, "bninception_rgb.pt"),
                    os.path.join(real, "rgb.pkl")], k1_3),
        ("real_ssn_test_flow", "ssn_test thumos14 Flow (BNInception)",
         ssn_test, ["thumos14", "Flow",
                    os.path.join(d, "bninception_flow.pt"),
                    os.path.join(real, "flow.pkl")], k1_3),
        ("real_binary_test", "binary_test thumos14 RGB (BNInception)",
         binary_test, ["thumos14", "RGB", "testing",
                       os.path.join(d, "pipeline", "binary.pt"), act], k1_3),
        ("real_ssn_train", f"ssn_train thumos14 RGB (BNInception, -b "
         f"{TRAIN_VIDEOS})", ssn_train, ["thumos14", "RGB"] + train,
         ("max_pool_bwd",)))
    with contextlib.chdir(real):
        for key, name, cli, argv, expect in runs:
            jpeg = argv + ["--data_root", frames, "--prop_file_dir", real]
            synth = argv + ["--synthetic_data", "--prop_file_dir", real]
            files.clear()
            training = key == "real_ssn_train"
            prof = {}
            fn = cli_call(cli, jpeg, key)
            if training:    # the counted run is the profiled one
                fn = (lambda fn=fn: prof.update(jpeg=profiled_run(fn)))
            with mock.patch.object(pipeline.DirectoryFrameProvider, "load",
                                   counted):
                paths[key] = drive(f"{name} on JPEG frames", fn,
                                   expect + ("host_jpeg_decode",))
            decodes = paths[key]["host_jpeg_decode"]
            if decodes != sum(files):
                raise AssertionError(
                    f"{name}: {decodes} JPEG decodes for {len(files)} frame "
                    f"loads reading {sum(files)} files")
            if key == "real_binary_test":
                with open(act, "rb") as f:
                    a = pickle.load(f)
                T = len(range(0, PIPELINE_FRAMES - 1, PIPELINE_INTERVAL))
                if len(a) != 2 or not all(v.shape == (T, 10, 2)
                                          and np.isfinite(v).all()
                                          for v in a.values()):
                    raise AssertionError("real-frame actionness pickle: " +
                                         str({k: v.shape
                                              for k, v in a.items()}))
            elif training:
                st = stats[key]
                if len(st.step_ms) != REAL_TRAIN_STEPS or not np.isfinite(
                        st.best_loss):
                    raise AssertionError(f"real-frame ssn_train: "
                                         f"{len(st.step_ms)} steps, best "
                                         f"loss {st.best_loss}")
            else:
                check_pickle(argv[3], 20)
                if key == "real_ssn_test_rgb":  # before the reruns below
                    with open(argv[3], "rb") as f:
                        rgb_pickle = f.read()
            if training:
                _, jw, jb = prof["jpeg"]
                _, sw, sb = profiled_run(cli_call(cli, synth,
                                                  key + "/synthetic"))
                walls = ""
                batches = (f"; JPEG {stats[key].summary()}; synthetic "
                           f"{stats[key + '/synthetic'].summary()}")
            else:
                t0 = time.perf_counter()
                cli_call(cli, synth, None)()
                walls = (f"JPEG wall {paths[key]['wall_s']:.3f} s, "
                         f"synthetic {time.perf_counter() - t0:.3f} s; ")
                batches = ""
                _, jw, jb = profiled_run(cli_call(cli, jpeg, None))
                _, sw, sb = profiled_run(cli_call(cli, synth, None))
            print(f"real frames: {name}: {walls}under the profiler JPEG "
                  f"wall {jw:.3f} s busy {jb / jw:.1%}, synthetic wall "
                  f"{sw:.3f} s busy {sb / sw:.1%}; {decodes} decodes for "
                  f"{len(files)} frame loads{batches} ({smi})", flush=True)

        # the same ssn_test on the coefficient-identical transcodes: the
        # same pixels, so the same pickle, byte for byte
        transcoded = os.path.join(real, "frames_tc")
        link_jpeg_frames(transcoded, videos, PIPELINE_FRAMES, rgb="tc")
        key, name, cli, argv, expect = runs[0]
        argv = argv[:3] + [os.path.join(real, "rgb_tc.pkl")]
        files.clear()
        with mock.patch.object(pipeline.DirectoryFrameProvider, "load",
                               counted):
            paths["real_ssn_test_rgb_tc"] = drive(
                f"{name} on progressive and arithmetic JPEG frames",
                cli_call(cli, argv + ["--data_root", transcoded,
                                      "--prop_file_dir", real], None),
                expect + ("host_jpeg_decode",))
        decodes = paths["real_ssn_test_rgb_tc"]["host_jpeg_decode"]
        if decodes != sum(files):
            raise AssertionError(
                f"{name} on transcodes: {decodes} JPEG decodes for "
                f"{len(files)} frame loads reading {sum(files)} files")
        with open(argv[3], "rb") as f:
            got = f.read()
        if got != rgb_pickle:
            delta = _max_abs_delta(pickle.loads(got), pickle.loads(rgb_pickle))
            raise AssertionError(
                f"{name}: the transcoded frames' pickle differs from the "
                f"baseline frames' (max |d| {delta})")
        print(f"real frames: {name} on the progressive and arithmetic "
              f"transcodes: wall {paths['real_ssn_test_rgb_tc']['wall_s']:.3f}"
              f" s, {decodes} decodes for {len(files)} frame loads, K1/K2/K3 "
              + "/".join(str(paths["real_ssn_test_rgb_tc"][k]) for k in k1_3)
              + f"; pickle byte-equal to the baseline frames' ({smi})",
              flush=True)

        # and on the same pixels as PNG, Adam7 PNG, BMP and PPM files
        # under the same img_*.jpg names (check_decoder wrote them)
        lossless = os.path.join(real, "frames_lossless")
        link_jpeg_frames(lossless, videos, PIPELINE_FRAMES,
                         rgb_dir=os.path.join(d, "lossless"))
        argv = argv[:3] + [os.path.join(real, "rgb_lossless.pkl")]
        files.clear()
        formats = ("host_png_decode", "host_bmp_decode", "host_pnm_decode")
        with mock.patch.object(pipeline.DirectoryFrameProvider, "load",
                               counted):
            run = paths["real_ssn_test_rgb_lossless"] = drive(
                f"{name} on PNG, BMP and PPM frames",
                cli_call(cli, argv + ["--data_root", lossless,
                                      "--prop_file_dir", real], None),
                expect + formats)
        decodes = sum(run[f] for f in formats)
        if decodes != sum(files) or run["host_jpeg_decode"]:
            raise AssertionError(
                f"{name} on PNG, BMP and PPM frames: {decodes} decodes "
                f"({run['host_jpeg_decode']} JPEG) for {len(files)} frame "
                f"loads reading {sum(files)} files")
        with open(argv[3], "rb") as f:
            got = f.read()
        if got != rgb_pickle:
            delta = _max_abs_delta(pickle.loads(got), pickle.loads(rgb_pickle))
            raise AssertionError(
                f"{name}: the PNG/BMP/PPM frames' pickle differs from the "
                f"JPEG frames' (max |d| {delta})")
        print(f"real frames: {name} on PNG, Adam7 PNG, BMP and PPM frames "
              f"named img_*.jpg: wall {run['wall_s']:.3f} s, PNG/BMP/PNM "
              "decodes " + "/".join(str(run[f]) for f in formats)
              + f" for {len(files)} frame loads, K1/K2/K3 "
              + "/".join(str(run[k]) for k in k1_3)
              + f"; pickle byte-equal to the JPEG frames' ({smi})",
              flush=True)
    return paths


def _leaf_digest(a) -> dict:
    """dtype, shape and sha256 of a checkpoint leaf's bytes (a bfloat16
    tensor's as uint16), as ``tests/test_torch_port_orbax.py`` writes
    them."""
    import hashlib

    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        dtype, a = str(a.dtype).split(".")[-1], a.view(torch.uint16).numpy()
    else:
        a = np.asarray(a)
        dtype = str(a.dtype)
    return {"dtype": dtype, "shape": list(a.shape), "sha256": hashlib.sha256(
        np.ascontiguousarray(a).tobytes()).hexdigest()}


def run_orbax(d: str) -> None:
    """The committed orbax directory (``tests/fixtures/torch_port_orbax``,
    a TinyConv SSN written by the JAX package's ``save_checkpoint_orbax``)
    and the port's writer (``save_checkpoint_orbax``). Where
    ``tensorstore`` imports: the directory's tree against the committed
    digests, then ``ssn_test --arch TinyConv`` scores it, and the port
    writes its tree back as a directory that reads to the same digests.
    Where it does not: the port refuses to read or write such a directory
    with an error naming tensorstore, which is what the port does on such
    a card."""
    import numpy as np

    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.models import state_dict_from_jax
    from action_detection_torch.train import load_checkpoint
    from action_detection_torch.train.checkpoint import (
        read_orbax, save_checkpoint_orbax)

    ck = os.path.join(ORBAX_FIXTURE, "ssn_tinyconv")
    try:
        import tensorstore  # noqa: F401
    except ImportError:
        written = os.path.join(d, "orbax_written")
        for what, call in (
                ("read", lambda: load_checkpoint(ck)),
                ("write", lambda: save_checkpoint_orbax(
                    written, {"activity_fc.bias": np.zeros(2, np.float32)},
                    REG_STATS, arch="TinyConv"))):
            try:
                call()
            except ImportError as e:
                if "tensorstore" not in str(e):
                    raise AssertionError(
                        f"orbax {what} refusal without its cause: {e}")
                print(f"orbax: this card has no tensorstore, so the port "
                      f"refuses to {what} orbax checkpoint directories: "
                      f"{str(e)[:160]}...", flush=True)
                continue
            raise AssertionError(f"an orbax directory {what} without "
                                 "tensorstore")
        if os.path.exists(written) or os.path.exists(written + ".tmp_ocp"):
            raise AssertionError("the refused orbax write left a directory")
        return
    with open(os.path.join(ORBAX_FIXTURE, "digests.json")) as f:
        want = json.load(f)
    tree = read_orbax(ck)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[prefix + k] = _leaf_digest(v)

    walk({"params": tree["params"], "batch_stats": tree["batch_stats"],
          "reg_stats": tree["reg_stats"]}, "")
    flat.update(epoch=tree["epoch"], best_loss=tree["best_loss"],
                arch=tree["arch"])
    if flat != want:
        raise AssertionError("orbax: the tree differs from its digests: " +
                             str(sorted(k for k in want
                                        if flat.get(k) != want[k])))
    out = os.path.join(d, "orbax.pkl")
    ssn_test(["thumos14", "RGB", ck, out, "--arch", "TinyConv",
              "--synthetic_data", "--prop_file_dir", d])
    print(f"orbax: the committed directory read to its {len(want)} digests "
          f"and scored (P={check_pickle(out, 20)})", flush=True)
    written = os.path.join(d, "orbax_written")
    save_checkpoint_orbax(written, state_dict_from_jax(
        tree["params"], tree["batch_stats"]), tree["reg_stats"],
        arch=tree["arch"], epoch=tree["epoch"], best_loss=tree["best_loss"])
    back = read_orbax(written)
    if {k: back[k] for k in ("epoch", "arch", "best_loss")} != {
            k: tree[k] for k in ("epoch", "arch", "best_loss")}:
        raise AssertionError("orbax: the port's directory reads back "
                             "otherwise")
    print("orbax: the port wrote the tree back as a directory that reads "
          "back", flush=True)


def run_recipe(d: str, smi: str) -> dict:
    """Main path, part 9: the port's THUMOS14 reproduction recipe
    (``action_detection_torch/scripts/reproduce_thumos14.sh``) run by
    ``bash`` as written, at full width (BNInception, the recipe's -b 16),
    in ``d/recipe``: ``gen_proposal_list`` -> ``ssn_train`` RGB and Flow
    (``$FLOW_INIT`` a seeded reference-format BNInception ``.pth``) ->
    ``ssn_test`` RGB and Flow (the int8-e2e shared-stem default) ->
    ``eval_detection_results`` fusing them 1:2. The dataset is
    ``tests/recipe_db.py``'s: normalized THUMOS14 lists of 2 train and 2
    test videos of 300 frames linking to the JPEG fixtures (20 train items
    at ``--tem`` 10: one step of 16 an epoch, one validation batch). The
    ``python`` shim first on ``PATH`` appends ``--epochs 1`` to
    ``ssn_train`` and nothing else, runs each CLI in its own process and
    prints its wall and launch counts: each training run must launch A1,
    each scoring run K1-K3, each its JPEG decodes. The mAP of seeded
    weights on 8 cycling frames means nothing; it is printed to show that
    the pipeline ran. Returns each step's launches."""
    import numpy as np
    import torch

    from tests.recipe_db import (map_row, recipe_steps, write_flow_init,
                                 write_python_shim, write_recipe_db)

    torch.cuda.empty_cache()    # the CLIs' processes share the card
    work = os.path.join(d, "recipe")
    frames = os.path.join(work, "frames")
    write_recipe_db(work, frames, "thumos14", train_videos=2, test_videos=2,
                    frames=300)
    bin_dir = os.path.join(work, "bin")
    write_python_shim(bin_dir, {("port", "ssn_train"): ["--epochs", "1"]})
    flow_init = os.path.join(work, "flow_init.pth")
    write_flow_init(flow_init, "BNInception", seed=12)
    env = dict(os.environ, PATH=bin_dir + os.pathsep + os.environ["PATH"],
               FLOW_INIT=flow_init)
    env.pop("KINETICS", None)
    script = os.path.join(ROOT, "action_detection_torch", "scripts",
                          "reproduce_thumos14.sh")
    t0 = time.perf_counter()
    proc = subprocess.run(["bash", script, frames, "work"], cwd=work,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    out = proc.stdout + proc.stderr
    if proc.returncode:
        raise AssertionError(f"recipe: exit {proc.returncode}:\n"
                             f"{out[-6000:]}")
    steps = recipe_steps(proc.stdout)
    clis = [s["cli"] for s in steps]
    want = ["gen_proposal_list", "ssn_train", "ssn_train", "ssn_test",
            "ssn_test", "eval_detection_results"]
    if clis != want:
        raise AssertionError(f"recipe: steps {clis}, not {want}")
    if "cross-modality first conv: 3 -> 10 channels" not in out:
        raise AssertionError("recipe: the Flow run did not read FLOW_INIT")
    paths = {}
    for step, (key, expect) in zip(steps[1:5], (
            ("recipe ssn_train RGB", ("max_pool_bwd",)),
            ("recipe ssn_train Flow", ("max_pool_bwd",)),
            ("recipe ssn_test RGB", ("int8_conv", "int8_max_pool",
                                     "int8_avg_pool")),
            ("recipe ssn_test Flow", ("int8_conv", "int8_max_pool",
                                      "int8_avg_pool")))):
        launches = step["launches"]
        for k in expect + ("host_jpeg_decode",):
            if launches[k] <= 0:
                raise AssertionError(f"{k} never launched on the {key} path")
        paths[key] = dict(launches, wall_s=step["wall_s"])
    for modality in ("rgb", "flow"):
        check_pickle(os.path.join(work, "work", f"scores_{modality}.pkl"), 20)
    for step in steps:
        launches = {k: v for k, v in step.get("launches", {}).items() if v}
        print(f"recipe: {step['cli']} {' '.join(step['argv'][:2])}: wall "
              f"{step['wall_s']:.2f} s, launches {launches} ({smi})",
              flush=True)
    table = out[out.rindex("Detection Performance on thumos14"):]
    print("recipe: " + "\nrecipe: ".join(table.splitlines()[:6]), flush=True)
    row = map_row(proc.stdout)
    if len(row) != 10 or not np.isfinite(row).all():
        raise AssertionError(f"recipe: mAP row {row}")
    print(f"recipe: reproduce_thumos14.sh ran end to end in {wall:.1f} s "
          f"(seeded weights: the mAP means nothing) ({smi})", flush=True)
    return paths


def _ddp_setup(d: str, device: str):
    """The model, optimizer and train step of the DDP comparison: a seeded
    BNInception SSN (dropout 0.8, the first BN on batch statistics:
    ``bn_mode`` partial, whose statistics are all-reduced), under DDP
    inside a process group."""
    from action_detection_torch.config import get_configs
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.parallel import wrap_ddp
    from action_detection_torch.train import make_optimizer, make_train_step

    cfg = get_configs("thumos14")
    model = seeded_init(SSN(num_class=cfg.num_class, stpp_cfg=cfg.stpp,
                            bn_mode="partial"), seed=1).to(device)
    opt = make_optimizer(model, base_lr=0.001, lr_steps=[3, 6],
                         steps_per_epoch=DDP_STEPS, clip_gradient=20.0)
    step = make_train_step(wrap_ddp(model, device), opt, cfg.sampling,
                           seed=1)
    return model, step


def _ddp_steps(d: str, rank: int, world: int) -> dict:
    """``DDP_STEPS`` train steps on this rank's slice of the saved global
    batches: metrics, step ms (CUDA events), the final state_dict and this
    rank's launch counts."""
    import numpy as np
    import torch

    from action_detection_torch.kernels import (launch_counts,
                                                reset_launch_counts)
    from action_detection_torch.parallel import shard_batch
    from action_detection_torch.train import batch_to_device

    model, step = _ddp_setup(d, "cuda")
    reset_launch_counts()
    metrics, ms = [], []
    for i in range(DDP_STEPS):
        with np.load(os.path.join(d, f"ddp_batch{i}.npz")) as z:
            batch = shard_batch({k: z[k] for k in z.files}, rank, world)
        db = batch_to_device(batch, "cuda")
        a = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        a.record()
        met = step(db)
        e.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(e))
        metrics.append({k: v.item() for k, v in met.items()})
    return {"metrics": metrics, "ms": ms, "launches": launch_counts(),
            "state": {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}}


def _ddp_rank(rank: int, world: int, port: int, d: str) -> None:
    """One spawned DDP rank on ``cuda:0`` (gloo: NCCL refuses two ranks on
    one card); its result goes to ``d/ddp_rank<rank>.pt``."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from action_detection_torch.parallel import initialize_multihost
    from action_detection_torch.train import float32_convs_and_matmuls

    torch.cuda.set_device(0)
    float32_convs_and_matmuls()
    initialize_multihost(f"127.0.0.1:{port}", world, rank, "gloo")
    try:
        out = _ddp_steps(d, rank, world)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(d, f"ddp_rank{rank}.pt"))


def ddp_two_ranks(d: str, p: str, smi: str) -> dict:
    """Two DDP ranks on the card (spawned, gloo) at -b ``DDP_VIDEOS`` each
    against one rank (this process, no process group) at -b
    ``2 * DDP_VIDEOS`` on the same global batches, ``DDP_STEPS`` steps:
    loss and grad_norm within 1e-4 relative, and every parameter's worst
    difference relative to its largest value (limit 1e-4; near-tied max
    pool windows may route differently where cuDNN picks another
    algorithm at the other batch size: the tensors that move are named).
    A1 runs at the BNInception pools in every rank. Returns the path's
    launches (the ranks' summed)."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    from action_detection_torch.parallel import free_port

    _, make_batch, _ = _train_setup(d, "cpu", seed=11)
    for i in range(DDP_STEPS):
        b = make_batch(range(2 * DDP_VIDEOS * i, 2 * DDP_VIDEOS * (i + 1)))
        np.savez(os.path.join(p, f"ddp_batch{i}.npz"), **b)
    ref = _ddp_steps(p, 0, 1)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ctx = mp.start_processes(_ddp_rank, args=(2, free_port(), p), nprocs=2,
                             join=False, start_method="spawn")
    # join returns False while a rank runs on; it raises if one failed
    while not ctx.join(timeout=5):
        if time.perf_counter() - t0 > 600:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError("DDP ranks did not finish in 600 s")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(p, f"ddp_rank{r}.pt")) for r in (0, 1)]
    launches = {k: sum(r["launches"][k] for r in ranks)
                for k in ranks[0]["launches"]}
    print(f"main path ddp 2 ranks (gloo, one card): wall {wall:.2f} s with "
          f"the ranks' start, launches {launches}", flush=True)
    if launches["max_pool_bwd"] <= 0:
        raise AssertionError("A1 never launched in the DDP ranks")
    for k in ("loss", "grad_norm"):
        for r in ranks:
            got = [m[k] for m in r["metrics"]]
            want = [m[k] for m in ref["metrics"]]
            if not np.allclose(got, want, rtol=1e-4, atol=0):
                raise AssertionError(f"DDP {k}: 2 ranks {got}, 1 rank {want}")
    # a tensor that started at zero (seeded_init's conv biases) is nothing
    # but its two updates: its difference relative to its largest value is
    # the relative difference of its gradient, a float32 sum over every
    # pixel of the batch, reduced in another order at another batch size
    # (and conv1's bias, under the batch-statistics BN, has a gradient of
    # rounding noise alone). Those are reported; every other tensor is held
    # to 1e-4 of its largest value.
    start = _ddp_setup(p, "cpu")[0].state_dict()
    worst, moved, from_zero = 0.0, [], []
    for name, w in ref["state"].items():
        if not w.is_floating_point():
            continue
        scale = w.abs().max().item()
        rel = max((r["state"][name] - w).abs().max().item()
                  for r in ranks) / (scale or 1.0)
        if not start[name].any():
            from_zero.append((name, rel))
            continue
        worst = max(worst, rel)
        if rel > 1e-4:
            moved.append((name, rel))
    zero_worst = max(from_zero, key=lambda t: t[1])
    zero_over = sorted(n for n, r in from_zero if r > 1e-4)
    print(f"ddp: 2 ranks x -b {DDP_VIDEOS} vs 1 rank x -b {2 * DDP_VIDEOS}, "
          f"{DDP_STEPS} steps: loss {[m['loss'] for m in ranks[0]['metrics']]}"
          f" vs {[m['loss'] for m in ref['metrics']]}, grad_norm "
          f"{[m['grad_norm'] for m in ranks[0]['metrics']]} vs "
          f"{[m['grad_norm'] for m in ref['metrics']]}; worst parameter "
          f"{worst:.2e} of its largest value (limit 1e-4) over the "
          f"{len(ref['state']) - len(from_zero)} tensors that started "
          f"nonzero; the {len(from_zero)} that started at zero (their own "
          f"updates): worst {zero_worst[0]} {zero_worst[1]:.2e}, "
          f"{len(zero_over)} over 1e-4; step ms rank 0 {ranks[0]['ms']}, "
          f"1 rank {ref['ms']} ({smi})", flush=True)
    if moved:
        raise AssertionError(f"DDP parameters over 1e-4: {moved}")
    return {"ddp_2_ranks": dict(launches, wall_s=wall)}


def ddp_cli(d: str, smi: str) -> dict:
    """``ssn_train thumos14 RGB -b 8`` (3 steps, validation, a checkpoint)
    without a process group, and with ``--gpus 0 --num_processes 1
    --process_id 0 --coordinator_address 127.0.0.1:<port>`` (one rank
    under DDP on NCCL); ``ssn_test`` scores the NCCL run's checkpoint.
    Prints both runs' median step. Run in ``d/train``."""
    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.cli.ssn_train import main as ssn_train
    from action_detection_torch.parallel import free_port

    t = os.getcwd()
    base = ["thumos14", "RGB", "--synthetic_data", "--prop_file_dir", t,
            "--print-freq", "1", "--clip-gradient", "20", "-b", "8",
            "--tem", str(3 * 8 // TRAIN_LIST_VIDEOS), "--epochs", "1"]
    stats, paths = {}, {}
    for key, extra in (
            ("ssn_train_plain", ["--snapshot_pref", "_plain"]),
            ("ssn_train_nccl", ["--snapshot_pref", "_nccl", "--gpus", "0",
                                "--num_processes", "1", "--process_id", "0",
                                "--coordinator_address",
                                f"127.0.0.1:{free_port()}"])):
        paths[key] = drive(f"{key.replace('_', ' ')} (-b 8)",
                           lambda extra=extra, key=key: stats.update(
                               {key: ssn_train(base + extra)}),
                           ("max_pool_bwd",))
    ckpt = os.path.join(t, "ssn_nccl_thumos14_BNInception_rgb_checkpoint.pt")
    scores = os.path.join(t, "nccl.pkl")
    paths["ssn_test_nccl"] = drive(
        "ssn_test on the NCCL run's checkpoint",
        lambda: ssn_test(["thumos14", "RGB", ckpt, scores,
                          "--synthetic_data", "--prop_file_dir", t]),
        ("int8_conv", "int8_max_pool", "int8_avg_pool"))
    print(f"ddp: NCCL checkpoint scored, pickle ok "
          f"(P={check_pickle(scores, 20)})", flush=True)
    med = {k: statistics.median(s.step_ms[1:]) for k, s in stats.items()}
    print(f"ddp: ssn_train -b 8 median step (steps 2-3) without a process "
          f"group {med['ssn_train_plain']:.2f} ms, one NCCL rank under DDP "
          f"{med['ssn_train_nccl']:.2f} ms ({smi})", flush=True)
    return paths


def write_thumos_db(d: str, frames: int = 1560, fps: int = 30) -> tuple:
    """A THUMOS14-style DB under ``d/thumos_14`` (durations, per-class
    temporal annotations, avoid lists; the shape of
    tests/test_video_db_and_tag_cli.py's fixture): two test videos of
    ``frames`` frames at ``fps`` with two GT instances each, one validation
    video, and frame folders of empty ``img_*.jpg`` files for the test
    videos. Returns the data dir and the frame root."""
    db, root = os.path.join(d, "thumos_14"), os.path.join(d, "frames")
    duration = frames / fps
    for subset, vids in (("validation", ["video_validation_0000001"]),
                         ("test", ["video_test_0000001",
                                   "video_test_0000002"])):
        anno = os.path.join(db, f"temporal_annotations_{subset}")
        os.makedirs(anno)
        with open(os.path.join(db, f"{subset}_durations.txt"), "w") as f:
            f.writelines(f"{v}.mp4\n{duration}\n" for v in vids)
        with open(os.path.join(db, f"{subset}_avoid_videos.txt"), "w") as f:
            f.write(f"{vids[0]} Ambiguous\n")
        for c, cls in enumerate(("BaseballPitch", "Diving")):
            with open(os.path.join(anno, f"{cls}_{subset}.txt"), "w") as f:
                f.writelines(f"{v} {8.0 + 25 * c + 3 * i:.1f} "
                             f"{20.0 + 25 * c + 3 * i:.1f}\n"
                             for i, v in enumerate(vids))
        if subset == "test":
            for v in vids:
                os.makedirs(os.path.join(root, v))
                for i in range(1, frames + 1):
                    open(os.path.join(root, v, f"img_{i:05d}.jpg"),
                         "w").close()
    return d, root


def run_pipeline(d: str, smi: str) -> dict:
    """Main path, part 5: the inference pipeline end to end in
    ``d/pipeline``: sliding windows -> ``binary_test`` (BNInception RGB,
    full width, int8-e2e shared stem, seeded weights) -> TAG grouping ->
    ``ssn_test`` on the TAG list (the BNInception RGB checkpoint of part 1)
    -> mAP; then the fused RGB + Flow evaluation of the pickles of parts 1
    and 4 (``--score_weights 1 1.5``). Two test videos of
    ``PIPELINE_FRAMES`` frames at 30 fps, actionness every
    ``PIPELINE_INTERVAL`` frames. Each stage's output is checked; returns
    ``binary_test``'s launches."""
    import contextlib

    import numpy as np

    from action_detection_torch.cli.binary_test import main as binary_test
    from action_detection_torch.cli.eval_detection_results import (
        main as eval_main)
    from action_detection_torch.cli.gen_bottom_up_proposals import (
        main as bottom_up)
    from action_detection_torch.cli.gen_sliding_window_proposals import (
        main as sliding_windows)
    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.data.proposal_io import load_proposal_file
    from action_detection_torch.models import BinaryClassifier, seeded_init
    from action_detection_torch.train import save_checkpoint

    p = os.path.join(d, "pipeline")
    os.makedirs(p)
    frames, interval = PIPELINE_FRAMES, PIPELINE_INTERVAL
    data_dir, root = write_thumos_db(p, frames)
    sw_list = os.path.join(p, "thumos14_sw_test_proposal_list.txt")
    sliding_windows(["testing", "rgb", root, sw_list, "--dataset",
                     "thumos14", "--data_dir", data_dir])
    groups = load_proposal_file(sw_list)
    if [g[1] for g in groups] != [frames] * 2 or not all(g[3] for g in
                                                         groups):
        raise AssertionError(f"sliding-window list: {[g[:2] for g in groups]}")

    model = seeded_init(BinaryClassifier(dropout=0.0), seed=6).eval()
    ckpt = os.path.join(p, "binary.pt")
    save_checkpoint(ckpt, model.state_dict(), None, arch="BNInception")
    act = os.path.join(p, "actionness.pkl")
    cli = ["thumos14", "RGB", "testing", ckpt, act, "--synthetic_data",
           "--prop_file_dir", p, "--frame_interval", str(interval)]
    launches = drive("binary_test thumos14 RGB (BNInception)",
                     lambda: binary_test(cli),
                     ("int8_conv", "int8_max_pool", "int8_avg_pool"))
    with open(act, "rb") as f:
        scores = pickle.load(f)
    T = len(range(0, frames - 1, interval))
    if sorted(scores) != ["video_test_0000001", "video_test_0000002"] or \
            not all(a.shape == (T, 10, 2) and np.isfinite(a).all()
                    for a in scores.values()):
        raise AssertionError("actionness pickle: " + str(
            {k: (a.shape, bool(np.isfinite(a).all()))
             for k, a in scores.items()}))
    print(f"pipeline: actionness pickle ok ({T}, 10, 2) per video",
          flush=True)
    _, wall, busy = profiled_run(lambda: binary_test(cli))
    print(f"pipeline: binary_test wall {launches['wall_s']:.3f} s; under "
          f"the profiler wall {wall:.3f} s, device busy {busy:.3f} s = "
          f"{busy / wall:.1%} ({smi})", flush=True)
    time_actionness(model, smi)

    tag_list = os.path.join(p, "thumos14_tag_test_proposal_list.txt")
    drive("gen_bottom_up_proposals", lambda: bottom_up([
        act, "--dataset", "thumos14", "--subset", "testing", "--data_dir",
        data_dir, "--frame_path", root, "--write_proposals", tag_list,
        "--workers", "1"]), ("host_tag_search", "host_nms"))
    groups = load_proposal_file(tag_list)
    if len(groups) != 2 or not all(g[3] for g in groups):
        raise AssertionError(f"TAG list: {[len(g[3]) for g in groups]} "
                             "proposals per video")
    print(f"pipeline: TAG proposals per video {[len(g[3]) for g in groups]}",
          flush=True)

    det = os.path.join(p, "tag_scores.pkl")
    drive("ssn_test thumos14 RGB on the TAG list", lambda: ssn_test([
        "thumos14", "RGB", os.path.join(d, "bninception_rgb.pt"), det,
        "--synthetic_data", "--prop_file_dir", p]),
        ("int8_conv", "int8_max_pool", "int8_avg_pool"))
    print(f"pipeline: pickle ok (P={check_pickle(det, 20)})", flush=True)

    dumps = [os.path.join(p, f) for f in ("gt_dump.pc", "pred_dump.pc")]
    for name, argv in (
            ("eval_detection_results (TAG list)", [det, "--prop_file_dir", p]),
            ("eval_detection_results (RGB + Flow fused)",
             [os.path.join(d, "bninception_rgb.pkl"),
              os.path.join(d, "bninception_flow.pkl"), "--score_weights",
              "1", "1.5", "--prop_file_dir", d])):
        out = {}
        for f in dumps:
            if os.path.exists(f):
                os.remove(f)
        with contextlib.chdir(p):      # where pandas exists, its dumps
            run = drive(name, lambda: out.update(
                ap=eval_main(["thumos14"] + argv)), ("host_nms",))
        ap = out["ap"]
        if ap.shape != (20, 9) or not np.isfinite(ap).all():
            raise AssertionError(f"{name}: AP {ap.shape}")
        written = all(os.path.exists(f) for f in dumps)
        print(f"pipeline: {name} wall {run['wall_s']:.3f} s, 9 IoU "
              f"columns, mean AP {ap.mean():.4f} (seeded weights), pandas "
              f"dumps {'written' if written else 'skipped'} ({smi})",
              flush=True)
    return launches


def time_actionness(model, smi) -> None:
    """Device time of one steady-state 64-tick actionness chunk (640 crops,
    int8-e2e shared stem, per-crop logits): CUDA events, median of 10."""
    import numpy as np
    import torch

    from action_detection_torch.infer.actionness import ActionnessScorer
    from action_detection_torch.kernels import (launch_counts,
                                                reset_launch_counts)

    rng = np.random.RandomState(2)
    frames = rng.randint(0, 256, size=(64, 256, 340, 3), dtype=np.uint8)
    calib = np.concatenate([frames[:2, 16:240, 58:282]] * 5)
    with ActionnessScorer(model, model.input_spec, chunk_frames=64,
                          device="cuda", quantize="e2e",
                          calibration_frames=calib,
                          shared_stem=True) as scorer:
        chunk = torch.as_tensor(frames).cuda()
        step = lambda: scorer._score_chunk(chunk)      # noqa: E731
        out = step()
        if out.shape != (64, 10, 2) or not torch.isfinite(out).all():
            raise AssertionError(f"actionness chunk {tuple(out.shape)}")
        ms = _time_ms(step, reps=10, warmup=2)
        reset_launch_counts()
        step()
        per_step = {k: n for k, n in launch_counts().items() if n}
    print(f"step: actionness BNInception int8-e2e shared-stem {ms:.2f} ms "
          f"per {SLICE_N}-crop chunk = {SLICE_N / ms * 1e3:.0f} crops/s, "
          f"launches per step {per_step} ({smi})", flush=True)


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


def check_rgbdiff(model, smi):
    """BNInception RGBDiff at 224^2: 64 ticks of 18-channel (6 RGB frames)
    scale-size stacks; the int8-e2e shared-stem step, its trunk on the card
    against the plain kernels, its features against the float backbone."""
    import numpy as np
    import torch

    from action_detection_torch.data.transforms import (
        device_oversample_normed)
    from action_detection_torch.models.backbones import (
        bn_inception_int8 as bq)

    rng = np.random.RandomState(3)
    frames = rng.randint(0, 256, size=(64, 256, 340, 18), dtype=np.uint8)
    calib = np.concatenate([frames[:2, 16:240, 58:282]] * 5)
    scorer, step = _time_steps("BNInception RGBDiff", model, frames, calib,
                               smi, modality="RGBDiff")
    x = device_oversample_normed(torch.as_tensor(frames[:2]).cuda(),
                                 model.input_spec, "RGBDiff", 5)
    _int8_checks("BNInception RGBDiff", model, scorer._quantized, x,
                 bq._e2e_stem_quantized,
                 lambda qe, h: bq._walk_trunk(bq._E2EOps(qe), h),
                 bq._e2e_trunk, bq.bninception_int8_e2e_features)
    return scorer, step


def check_perlayer(model, smi, profile=None):
    """``--int8_mode perlayer`` (BNInception RGB at 224^2, static scales
    from 10 calibration crops): the steady-state 640-crop step; the
    per-layer activations on the card (K1's bf16 epilogue, torch's bf16
    pools) bit-exact against the plain kernels on the CPU at 4 crops, the
    features within one bf16 ulp (the float32 global mean may round
    differently across devices); the features of 20 crops against the float
    backbone (min cos > 0.99, rel RMS < 0.12). With ``profile``, the
    step's device time by part (``perlayer_breakdown``)."""
    import numpy as np
    import torch

    from action_detection_torch.data.transforms import (
        device_oversample_normed)
    from action_detection_torch.infer.scorer import ProposalScorer
    from action_detection_torch.kernels import (launch_counts,
                                                reset_launch_counts)
    from action_detection_torch.models.backbones import (
        bn_inception_int8 as bq)

    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, size=(64, 256, 340, 3), dtype=np.uint8)
    calib = np.concatenate([frames[:2, 16:240, 58:282]] * 5)
    spec = model.input_spec
    scorer = ProposalScorer(model, spec,
                            reg_stats=np.asarray(REG_STATS, np.float32),
                            num_class=model.num_class, chunk_frames=64,
                            device="cuda", quantize="perlayer",
                            calibration_frames=calib)
    chunk = torch.as_tensor(frames).cuda()
    step = lambda: scorer._score_chunk(chunk, 64)      # noqa: E731
    step_ms = _time_ms(step, reps=10, warmup=2)
    reset_launch_counts()
    step()
    per_step = {k: n for k, n in launch_counts().items() if n}
    print(f"step: BNInception int8 perlayer (static scales) {step_ms:.2f} ms "
          f"per {SLICE_N}-crop step = {SLICE_N / step_ms * 1e3:.0f} crops/s, "
          f"launches per step {per_step} ({smi})", flush=True)

    q, scales = scorer._quantized, scorer._act_scales

    def acts(q, scales, x):        # the last concat, before the mean
        ops = bq._PerLayerOps(q, act_scales=scales)
        return bq._walk_trunk(ops, bq._walk_stem(ops, x.to(torch.bfloat16)))

    x = device_oversample_normed(torch.as_tensor(frames[:1]).cuda(),
                                 spec)[:4]
    q_cpu, s_cpu = bq.tree_to(q, "cpu"), bq.tree_to(scales, "cpu")
    with torch.no_grad():
        got, ref = acts(q, scales, x).cpu(), acts(q_cpu, s_cpu, x.cpu())
        if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
            raise AssertionError("perlayer activations on the card differ "
                                 "from the plain kernels on the CPU in "
                                 f"{(got != ref).sum().item()} values")
        fgot = bq.bninception_int8_features(q, x, scales).cpu()
        fref = bq.bninception_int8_features(q_cpu, x.cpu(), s_cpu)
        ulp = torch.exp2(torch.floor(torch.log2(
            fref.abs().clamp_min(1e-30))) - 7)
        d = (fgot - fref).abs()
        if not (d <= ulp).all():
            raise AssertionError("perlayer features on the card vs the CPU: "
                                 f"{(d / ulp).max().item()} bf16 ulp")
        print(f"check: BNInception perlayer activations (K1 bf16 epilogue "
              f"on the card) == plain versions on the CPU, bit-exact, "
              f"{tuple(got.shape)}; features {(d == 0).float().mean():.4f} "
              f"equal, max {(d / ulp).max().item():.1f} bf16 ulp",
              flush=True)
        x20 = device_oversample_normed(torch.as_tensor(frames[:2]).cuda(),
                                       spec)
        f32 = model.to("cuda").eval().base_model(x20).double().cpu()
        q8 = bq.bninception_int8_features(q, x20, scales).double().cpu()
        model.to("cpu")
    cos = torch.nn.functional.cosine_similarity(f32, q8, dim=1).min()
    rel = ((q8 - f32).norm() / f32.norm()).item()
    if not (cos > 0.99 and rel < 0.12):
        raise AssertionError(f"perlayer features vs float: cos {cos} rel "
                             f"{rel}")
    print(f"check: BNInception int8 perlayer vs float features: min cos "
          f"{cos.item():.6f}, rel rms {rel:.5f}", flush=True)
    if profile:
        perlayer_breakdown(q, scales, device_oversample_normed(
            chunk, spec), smi)
    return scorer, step


def perlayer_breakdown(q, scales, x, smi) -> None:
    """Device ms of one 640-crop per-layer forward by part: CUDA events
    around each op on the one stream (the host runs ahead of these
    kernels, so a pair brackets its op's kernels): the quantize passes
    (max, divide, round, clamp, int8), K1 (a conv's time less its
    quantize), the bf16 max pools, the bf16 avg pools, the concats, and
    the rest (the bf16 cast, the mean)."""
    import torch

    from action_detection_torch.models.backbones import (
        bn_inception_int8 as bq)

    marks = []

    def timed(part, fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        marks.append((part, a, b))
        return out

    base = bq._PerLayerOps

    class Timed(base):
        def quantize(self, *a):
            return timed("quantize", lambda: base.quantize(self, *a))

        def conv(self, *a, **kw):
            return timed("conv", lambda: base.conv(self, *a, **kw))

        def max_pool(self, *a, **kw):
            return timed("bf16 max pool",
                         lambda: base.max_pool(self, *a, **kw))

        def avg_pool(self, *a):
            return timed("bf16 avg pool", lambda: base.avg_pool(self, *a))

        def concat(self, parts):
            return timed("concat", lambda: base.concat(self, parts))

    def forward():
        ops = Timed(q, act_scales=scales)
        h = bq._walk_trunk(ops, bq._walk_stem(ops, x.to(torch.bfloat16)))
        return h.float().mean(dim=(1, 2)).to(torch.bfloat16)

    with torch.no_grad():
        forward()
        marks.clear()
        torch.cuda.synchronize()
        timed("total", forward)
        torch.cuda.synchronize()
    parts = {}
    for p, a, b in marks:
        parts[p] = parts.get(p, 0.0) + a.elapsed_time(b)
    whole = parts.pop("total")
    parts["K1"] = parts.pop("conv") - parts["quantize"]
    parts["rest"] = whole - sum(parts.values())
    print(f"profile perlayer: {whole:.2f} ms per {x.shape[0]}-crop forward "
          "(CUDA events): " + ", ".join(
              f"{p} {ms:.2f} ms ({ms / whole:.1%})"
              for p, ms in sorted(parts.items(), key=lambda kv: -kv[1]))
          + f" ({smi})", flush=True)


def run_int8_stem(d: str, models: dict, smi: str) -> dict:
    """Phase int8_stem: the all-int8 stems (``hybrid_stem=False``) at full
    width, for BNInception RGB and Flow (THUMOS14, K = 20) and InceptionV3
    RGB (ActivityNet v1.2, K = 100, 299^2). For each: the hybrid
    shared-stem scorer calibrated on 10 crops; the all-int8 tree from
    ``calibrate_e2e`` / ``calibrate_e2e_iv3(..., hybrid_stem=False)`` on the
    same crops, handed to a second scorer through ``prequantized=`` (as the
    JAX package reaches it); one 1,560-frame video scored through it
    (``score_video``: a path of its own that must launch K1-K3); the
    640-crop step of both scorers in turns (median of 10, CUDA events) and
    their launches a step (the all-int8 step launches K1 3 (BNInception) or
    5 (InceptionV3) and K2 2 times more: its stem); the all-int8 stem on
    the card bit-exact against the plain kernels on the CPU,
    ``_int8_checks`` (its trunk bit-exact, its features against float:
    min cos > 0.99, rel RMS < 0.12) and its features against the hybrid
    tree's. Returns each path's launches."""
    import numpy as np
    import torch

    from action_detection_torch.config import get_configs
    from action_detection_torch.data.pipeline import SyntheticFrameProvider
    from action_detection_torch.data.ssn_dataset import SSNDataset
    from action_detection_torch.data.transforms import (
        device_oversample_normed)
    from action_detection_torch.infer.scorer import ProposalScorer
    from action_detection_torch.kernels import (launch_counts,
                                                reset_launch_counts)
    from action_detection_torch.models.backbones import (
        bn_inception_int8 as bq)
    from action_detection_torch.models.backbones import (
        inception_v3_int8 as iq)

    class IV3Acts(iq._ForwardOps):      # the last concat, before the mean
        def finish(self, y):
            return y

    t_start = time.perf_counter()
    paths = {}
    for key, dataset, modality, n_check in (
            ("bninception_rgb", "thumos14", "RGB", 10),
            ("bninception_flow", "thumos14", "Flow", 10),
            ("inceptionv3_rgb", "activitynet1.2", "RGB", 4)):
        model = models[key]
        spec, cfg = model.input_spec, get_configs(dataset)
        iv3 = model.arch == "InceptionV3"
        new_length = model.resolved_new_length
        if iv3:
            calibrate, stem = iq.calibrate_e2e_iv3, iq._iv3_stem_quantized
            trunk_ops = lambda qe, h: iq._walk_trunk(IV3Acts(qe), h)  # noqa
            trunk, features = iq.iv3_trunk, iq.inception_v3_int8_e2e_features
            stem_convs, k3 = 5, "int8_avg_pool_exclude_pad"
        else:
            calibrate, stem = bq.calibrate_e2e, bq._e2e_stem_quantized
            trunk_ops = lambda qe, h: bq._walk_trunk(bq._E2EOps(qe), h)  # noqa
            trunk, features = bq._e2e_trunk, bq.bninception_int8_e2e_features
            stem_convs, k3 = 3, "int8_avg_pool"
        S, cs = spec.scale_size, spec.input_size
        W = S * 340 // 256                    # 340x256, 452x341 frames
        rng = np.random.RandomState(11)
        frames = rng.randint(0, 256, size=(64, S, W, 3 if modality == "RGB"
                                           else 10), dtype=np.uint8)
        oy, ox = (S - cs) // 2, (W - cs) // 2
        calib = np.concatenate([frames[:2, oy:oy + cs, ox:ox + cs]] * 5)
        kw = dict(reg_stats=np.asarray(REG_STATS, np.float32),
                  num_class=model.num_class, stpp_cfg=cfg.stpp,
                  chunk_frames=64, modality=modality, device="cuda",
                  quantize="e2e", shared_stem=True)
        hybrid = ProposalScorer(model, spec, calibration_frames=calib, **kw)
        with torch.no_grad():
            sample = hybrid._prep_calibration(torch.as_tensor(calib).cuda())
        qe8 = calibrate(model.base_model.state_dict(), sample,
                        hybrid_stem=False)
        if "__stem__" in qe8 or "__stem__" not in hybrid._quantized:
            raise AssertionError(f"{key}: the trees' stems are wrong")
        allint8 = ProposalScorer(model, spec, prequantized=(qe8, None),
                                 **kw)

        ds = SSNDataset(os.path.join(d, f"{cfg.test_list}_proposal_list"
                                        ".txt"), cfg.sampling,
                        new_length=new_length, test_interval=6)
        provider = SyntheticFrameProvider(modality=modality)
        scored = {}
        paths[f"int8_stem {key}"] = drive(
            f"int8_stem {key}: score_video through the all-int8 tree "
            "(prequantized=)", lambda: scored.update(out=allint8.score_video(
                ds.get_test_sample(0), provider)),
            ("int8_conv", "int8_max_pool", k3))
        out = scored["out"]
        for a in (out.act_scores, out.comp_scores, out.reg_scores):
            if not np.isfinite(a).all() or a.shape[0] != len(out.rel_props):
                raise AssertionError(f"int8_stem {key}: scores {a.shape}")

        chunk = torch.as_tensor(frames).cuda()
        steps = {"hybrid": hybrid, "all-int8": allint8}
        ms, per_step = {n: [] for n in steps}, {}
        for name in ("hybrid", "all-int8", "all-int8", "hybrid"):
            ms[name].append(_time_ms(
                lambda sc=steps[name]: sc._score_chunk(chunk, 64), reps=10,
                warmup=2))
        for name, sc in steps.items():
            reset_launch_counts()
            sc._score_chunk(chunk, 64)
            torch.cuda.synchronize()
            per_step[name] = {k: n for k, n in launch_counts().items() if n}
        more = tuple(per_step["all-int8"].get(k, 0) - per_step["hybrid"].get(
            k, 0) for k in ("int8_conv", "int8_max_pool"))
        th, t8 = (" / ".join(f"{t:.2f}" for t in ms[n]) for n in steps)
        print(f"step: {model.arch} {modality} {SLICE_N}-crop shared-stem "
              f"step, hybrid stem {th} ms, all-int8 stem {t8} ms (turns "
              f"hybrid, int8, int8, hybrid; median of 10 each); launches a "
              f"step hybrid {per_step['hybrid']}, all-int8 "
              f"{per_step['all-int8']} ({smi})", flush=True)
        if more != (stem_convs, 2):
            raise AssertionError(f"int8_stem {key}: the all-int8 step "
                                 f"launched K1/K2 {more} more than the "
                                 f"hybrid one, not {(stem_convs, 2)}")

        x = device_oversample_normed(chunk[:2], spec, modality,
                                     new_length)[:n_check]
        qd = allint8._quantized
        with torch.no_grad():
            h = stem(qd, x).cpu()
            href = stem(bq.tree_to(qd, "cpu"), x.cpu())
        if not torch.equal(h, href):
            raise AssertionError(f"{key} all-int8 stem on the card differs "
                                 "from the plain kernels on the CPU in "
                                 f"{(h != href).sum().item()} values")
        print(f"check: {model.arch} {modality} all-int8 stem (K1, K2 on the "
              f"card) == plain versions on the CPU, bit-exact, "
              f"{tuple(h.shape)}", flush=True)
        _int8_checks(f"{model.arch} {modality} all-int8 stem", model, qd, x,
                     stem, trunk_ops, trunk, features)
        with torch.no_grad():
            fh = features(hybrid._quantized, x).double().cpu()
            f8 = features(qd, x).double().cpu()
        cos = torch.nn.functional.cosine_similarity(fh, f8, dim=1).min()
        rel = ((f8 - fh).norm() / fh.norm()).item()
        print(f"check: {model.arch} {modality} all-int8 vs hybrid-stem "
              f"features: min cos {cos.item():.6f}, rel rms {rel:.5f}",
              flush=True)
        hybrid.close()
        allint8.close()
        del chunk, x, qd, qe8
        torch.cuda.empty_cache()
    print(f"timing: the int8_stem phase {time.perf_counter() - t_start:.1f}"
          " s", flush=True)
    return paths


def run_quantization_report(smi: str) -> None:
    """Phase quantization_report: ``quantization_report`` in both modes on
    BNInception RGB at 224^2, on 20 crops (2 ticks x 10) of random 340x256
    frames, with a THUMOS14 SSN's fused test FC and score layout; the
    weights are torch's default init (seed 3) with perturbed BN statistics
    (tests/test_int8.py's torch twin). Every key printed; feature cosine >
    0.99 and feature relative RMS < 0.1 in both modes."""
    import numpy as np
    import torch

    from action_detection_torch.config import get_configs
    from action_detection_torch.data.transforms import (
        device_oversample_normed)
    from action_detection_torch.models import SSN
    from action_detection_torch.models.backbones.bn_inception_int8 import (
        quantization_report)
    from action_detection_torch.models.ssn import fuse_test_heads
    from action_detection_torch.ops.stpp import (ReorganizedScoreLayout,
                                                 StppConfig)

    t0 = time.perf_counter()
    cfg = get_configs("thumos14")
    torch.manual_seed(3)
    model = SSN(num_class=cfg.num_class, dropout=0.0, stpp_cfg=cfg.stpp)
    with torch.no_grad():
        for m in model.base_model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.02)
                m.running_var.uniform_(0.9, 1.4)
                m.weight.normal_(1.0, 0.02)
                m.bias.normal_(0, 0.02)
    kernel, bias = fuse_test_heads(model, cfg.num_class, cfg.stpp)
    K = cfg.num_class
    layout = ReorganizedScoreLayout(
        K + 1, K, 2 * K, StppConfig.from_raw(cfg.stpp).feat_multiplier)
    backbone = model.base_model.to("cuda")
    rng = np.random.RandomState(12)
    frames = torch.as_tensor(rng.randint(0, 256, size=(2, 256, 340, 3),
                                         dtype=np.uint8)).cuda()
    x = device_oversample_normed(frames, model.input_spec)
    for mode in ("perlayer", "e2e"):
        rep = quantization_report(backbone, backbone.state_dict(), x,
                                  fused_kernel=kernel, fused_bias=bias,
                                  layout=layout, mode=mode)
        print(f"quantization_report {mode} (BNInception RGB, "
              f"{x.shape[0]} crops of 224^2): "
              + ", ".join(f"{k} {v:.6f}" for k, v in rep.items())
              + f" ({smi})", flush=True)
        if not (rep["feature_cosine"] > 0.99
                and rep["feature_rel_rms"] < 0.1):
            raise AssertionError(f"quantization_report {mode}: {rep}")
    backbone.to("cpu")
    print(f"timing: the quantization_report phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def run_pool_modes(d: str, smi: str) -> dict:
    """Phase pool_modes: one BNInception RGB training step
    (``make_train_step``, -b ``TRAIN_VIDEOS`` = 1,152 images, dropout 0.8)
    from the same weights on the same batch in each max-pool backward mode:
    ``"pallas"`` and ``"sas"`` (first-match: A1 at every pool, the same
    launches in both) and ``"eq_mask"`` (its strided pools on the eq-mask
    backward, A1 at the stride-1 5b pool only, so fewer launches). The
    first step of each mode runs with cuDNN's deterministic algorithms
    (and torch's where it has them), so its gradients can be compared: the
    losses equal across the modes, ``"sas"`` equal to ``"pallas"`` bit for
    bit, eq-mask's largest |d grad| against ``"pallas"`` printed. ``POOL_MODE_STEPS`` more steps of each mode, with cuDNN's
    defaults, give its step ms (the median) and peak memory. Returns each
    mode's launches."""
    import warnings

    import torch

    from action_detection_torch.ops import pooling
    from action_detection_torch.train import batch_to_device

    t0 = time.perf_counter()
    _, make_batch, _ = _train_setup(d, "cuda", seed=1)
    batch = batch_to_device(make_batch(range(TRAIN_VIDEOS)), "cuda")
    prev = pooling.pool_backward()
    paths, res = {}, {}
    try:
        for i, mode in enumerate(("pallas", "sas", "eq_mask")):
            pooling.set_pool_backward(mode)
            model, _, step = _train_setup(d, "cuda", seed=1)
            got = {}
            torch.backends.cudnn.deterministic = True
            torch.use_deterministic_algorithms(True, warn_only=True)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                paths[f"pool_modes {mode}"] = drive(
                    f"pool_modes: train step, pool backward {mode!r}",
                    lambda: got.update(met=step(batch)), ("max_pool_bwd",))
            torch.backends.cudnn.deterministic = False
            torch.use_deterministic_algorithms(False)
            nondet = sorted({str(w.message).splitlines()[0] for w in caught
                             if "deterministic" in str(w.message)})
            grads = {n: p.grad.detach().clone()
                     for n, p in model.named_parameters()
                     if p.grad is not None}
            torch.cuda.reset_peak_memory_stats()
            ms = []
            for _ in range(POOL_MODE_STEPS):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                step(batch)
                b.record()
                torch.cuda.synchronize()
                ms.append(a.elapsed_time(b))
            res[i] = (mode, got["met"]["loss"].item(), grads,
                      statistics.median(ms),
                      torch.cuda.max_memory_allocated() / 2 ** 30)
            print(f"pool_modes {mode}: loss {res[i][1]:.7f}, step "
                  f"{res[i][3]:.2f} ms (median of "
                  f"{', '.join(f'{t:.2f}' for t in ms)}), peak "
                  f"{res[i][4]:.2f} GiB "
                  f"({TRAIN_N} images, float32, TF32 off"
                  + (f"; without a deterministic implementation: {nondet}"
                     if nondet else "") + f") ({smi})", flush=True)
            del model, step
            torch.cuda.empty_cache()
    finally:
        pooling.set_pool_backward(prev)
        torch.backends.cudnn.deterministic = False
        torch.use_deterministic_algorithms(False)

    def worst(g1, g2):
        return max((g1[n] - g2[n]).abs().max().item() for n in g1)

    base = res[0][2]
    scale = max(g.abs().max().item() for g in base.values())
    sas, eq = worst(res[1][2], base), worst(res[2][2], base)
    a1 = [paths[f"pool_modes {m}"]["max_pool_bwd"]
          for m in ("pallas", "sas", "eq_mask")]
    print(f"pool_modes: |d grad| against 'pallas' over every parameter: "
          f"'sas' {sas}, 'eq_mask' {eq} ({eq / scale:.2e} of the largest "
          f"gradient element {scale:.4g}); A1 launches pallas/sas/eq_mask "
          f"{a1}; eq_mask step {res[2][3]:.2f} ms against pallas "
          f"{res[0][3]:.2f} and sas {res[1][3]:.2f}, peak {res[2][4]:.2f} "
          f"GiB against {res[0][4]:.2f} and {res[1][4]:.2f} ({smi})",
          flush=True)
    losses = {res[i][1] for i in res}
    if len(losses) != 1 or sas != 0.0 or a1[1] != a1[0] or \
            not 0 < a1[2] < a1[0]:
        raise AssertionError(f"pool_modes: losses {losses}, 'sas' |d| "
                             f"{sas}, A1 launches {a1}")
    print(f"timing: the pool_modes phase {time.perf_counter() - t0:.1f} s",
          flush=True)
    return paths


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


def profiled_run(fn):
    """``fn()`` under torch.profiler: returns the profile, the wall seconds
    and the device's busy seconds (the union of its kernels' intervals)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return prof, wall, _busy_us(_device_intervals(prof)) / 1e6


def profile_cli(out_dir: str, name: str, cli) -> None:
    """Device busy share of one whole ``ssn_test`` run."""
    from action_detection_torch.cli.ssn_test import main as ssn_test

    prof, wall, busy = profiled_run(lambda: ssn_test(cli))
    with open(_profile_out(out_dir, name), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=40))
    print(f"profile {name}: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy * 1e3:.1f} ms = {busy / wall:.1%}", flush=True)


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
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    # the port must be importable before anything is printed
    from action_detection_torch.kernels.build import build_library
    from action_detection_torch.utils.native import build_native

    smi = _smi()
    card = torch.cuda.get_device_name(0)
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {sys.version.split()[0]}", flush=True)

    path, secs = build_library()
    print(f"build: {os.path.relpath(path, ROOT)} in {secs:.1f} s", flush=True)
    t0 = time.perf_counter()
    host = build_native()
    print(f"build: {os.path.relpath(host, ROOT)} (host kernels) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    rows = check_kernels(card)
    print(f"timing: build and kernel phase {time.perf_counter() - t_start:.1f}"
          " s", flush=True)
    paths = main_path(card, smi, rows, profile)
    print(f"timing: the whole run {time.perf_counter() - t_start:.1f} s",
          flush=True)

    conv, pool = ("action_detection_torch/csrc/int8_conv.cu",
                  "action_detection_torch/csrc/int8_pool.cu")
    # row -> (source, TPU function it replaces, main path, launch counter)
    sources = {
        "int8_conv": (conv, f"{TPU_SRC}:257", "bninception_rgb",
                      "int8_conv"),
        "int8_conv/per_axis_pad": (conv, f"{IV3_SRC}:288", "inceptionv3_rgb",
                                   "int8_conv"),
        "int8_conv/perlayer": (conv, f"{TPU_SRC}:79", "bninception_perlayer",
                               "int8_conv"),
        "int8_conv/int8_stem": (conv, f"{TPU_SRC}:451",
                                "int8_stem bninception_rgb", "int8_conv"),
        "int8_conv/int8_stem_iv3": (conv, f"{IV3_SRC}:398",
                                    "int8_stem inceptionv3_rgb",
                                    "int8_conv"),
        "int8_max_pool": (pool, f"{TPU_SRC}:230", "bninception_rgb",
                          "int8_max_pool"),
        "int8_max_pool/stem": (pool, f"{TPU_SRC}:451",
                               "int8_stem bninception_rgb", "int8_max_pool"),
        "int8_max_pool/stem_iv3": (pool, f"{IV3_SRC}:398",
                                   "int8_stem inceptionv3_rgb",
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
            "library_ms": sum(lib) if lib else None,
            # launches of the counter on the data-parallel paths
            "parallel_paths": {p: paths[p][counter] for p in PARALLEL_PATHS
                               if paths[p][counter]}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
