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
              variants) and K3 (int8 avg pool) at the scoring slice's own
              shapes (640 crops), and A1 (max-pool backward) at every
              BNInception max pool of the training step (1,152 images),
              each held EXACTLY equal to its plain torch version on the same
              inputs; median ms of both. A1 also launches twice on the same
              inputs (equal bits) and prints GB/s of |x|+|y|+|dy|+|dx|.
4. main     — the port's ``ssn_test`` CLI in-process, at full BNInception
              224^2 width with the int8-e2e shared-stem default, on 2
              synthetic THUMOS14 videos of 1,560 frames with seeded random
              weights; then SSN training steps at full width (BNInception
              224^2, 16 videos x 8 proposals x 9 segments = 1,152 images per
              step, frozen BN, dropout 0.8) through ``make_train_step``.
              Every kernel must have launched in this phase; the score
              pickle is checked for shapes and finite values and the
              training metrics for finite values.
5. checks   — the int8 trunk held bit-exact against the plain kernels on
              the CPU, the int8 features against the float backbone
              (cos > 0.99, rel < 0.12), a small train step on the card
              against the same step on the CPU, and the steady-state times
              of one 640-crop scoring step and of one training step.

``python3 chip_smoke.py --profile DIR`` adds a torch.profiler phase: the
per-kernel device time and the device busy share of a scoring step, a
training step and the whole ``ssn_test`` run, with the full tables written
to ``DIR/profile_*.txt``.

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
TPU_SRC = "action_detection_tpu/models/backbones/bn_inception_int8.py"


def _smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median device time of ``fn()`` in ms (CUDA events)."""
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


def check_kernels(card: str) -> list:
    """Phase 3: K1-K3 against their plain versions at the slice's shapes."""
    import torch

    from action_detection_torch.kernels import int8 as k
    from action_detection_torch.kernels import pool_bwd as a1
    from action_detection_torch.models.backbones.bn_inception import pool_pads
    from action_detection_torch.ops.pooling import _reduce_max

    g = torch.Generator(device="cuda").manual_seed(0)
    dev = "cuda"

    def act(*shape):   # post-ReLU int8 activations
        return torch.randint(0, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def weights(O, kh, kw, C):
        return torch.randint(-127, 128, (O, kh, kw, C), generator=g,
                             device=dev, dtype=torch.int8)

    rows = {"int8_conv": [], "int8_max_pool": [], "int8_avg_pool": [],
            "max_pool_bwd": []}

    def record(name, label, got, ref, fn, plain, nbytes=None):
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}[{label}] differs from its plain "
                                 f"version: max |diff| {err}")
        ms = _time_ms(fn, reps=10)
        plain_ms = _time_ms(plain, reps=3)
        rows[name].append((label, err, ms, plain_ms))
        rate = ""
        if nbytes:   # bytes the op must move, over the card's HBM peak
            gbs = nbytes / ms / 1e6
            rate = f", {gbs:.0f} GB/s = {gbs / HBM_GBS:.1%} of 3.35 TB/s"
        print(f"kernel {name}[{label}]: equal, max|d|={err} {ms:.3f} ms "
              f"(plain {plain_ms:.3f} ms){rate} on {card}", flush=True)

    # K1: the 3a fused entry conv, a 3a 3x3 reading its slice of the entry
    # output in place, the 3c 3x3 s2, a 4e 3x3 s2, the 5b fused entry conv
    entry3a = act(SLICE_N, 28, 28, 192)
    conv_cases = [
        ("3a_entry_1x1", entry3a, weights(192, 1, 1, 192), 1, 0),
        ("3a_3x3_on_slice", entry3a[..., 64:128], weights(64, 3, 3, 64), 1, 1),
        ("3c_3x3_s2", act(SLICE_N, 28, 28, 128), weights(160, 3, 3, 128), 2, 1),
        ("4e_double_3x3_2_s2", act(SLICE_N, 14, 14, 256),
         weights(256, 3, 3, 256), 2, 1),
        ("5b_entry_1x1", act(SLICE_N, 7, 7, 1024), weights(736, 1, 1, 1024),
         1, 0),
    ]
    for label, x, w, stride, pad in conv_cases:
        O, kh, kw, C = w.shape
        # per-channel epilogue scales that put outputs across the int8 range
        spread = float(C * kh * kw) ** 0.5 * 64 * 73
        m = (torch.rand(O, generator=g, device=dev) + 0.5) * (64.0 / spread)
        bq = torch.randn(O, generator=g, device=dev) * 8.0
        for out_dtype, tag in ((torch.int8, "i8"), (torch.bfloat16, "bf16")):
            def fn(x=x, w=w, m=m, bq=bq, s=stride, p=pad, o=out_dtype):
                return k.int8_conv(x, w, m, bq, s, p, o)

            def plain(x=x, w=w, m=m, bq=bq, s=stride, p=pad, o=out_dtype):
                return k.int8_conv_plain(x, w, m, bq, s, p, o)

            record("int8_conv", f"{label}/{tag}", fn(), plain(), fn, plain)

    # K2: the 3c passthrough ceil pool (s2) and the 5b pool branch (s1 p1)
    for label, x, a in (
            ("3c_ceil_s2", act(SLICE_N, 28, 28, 320),
             (3, 2, pool_pads(28, 28, 3, 2, ceil=True))),
            ("5b_s1_p1", act(SLICE_N, 7, 7, 1024),
             (3, 1, pool_pads(7, 7, 3, 1, pad=1)))):
        x = x - 64    # signed values, so -128 padding must never win
        record("int8_max_pool", label, k.int8_max_pool(x, *a),
               k.int8_max_pool_plain(x, *a),
               lambda x=x, a=a: k.int8_max_pool(x, *a),
               lambda x=x, a=a: k.int8_max_pool_plain(x, *a))

    # K3: the 3a pool branch
    x = act(SLICE_N, 28, 28, 192)
    record("int8_avg_pool", "3a_s1_p1", k.int8_avg_pool(x, 3, 1, 1),
           k.int8_avg_pool_plain(x, 3, 1, 1),
           lambda: k.int8_avg_pool(x, 3, 1, 1),
           lambda: k.int8_avg_pool_plain(x, 3, 1, 1))
    del entry3a, conv_cases, x

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
        # |x| + |y| + |dy| + |dx|: every byte across HBM once
        nbytes = 2 * (x.numel() + y.numel()) * x.element_size()
        record("max_pool_bwd", label, got, a1.max_pool_bwd_plain(x, dy, *geo),
               lambda x=x, y=y, dy=dy, geo=geo: a1.max_pool_bwd(x, y, dy,
                                                                *geo),
               lambda x=x, dy=dy, geo=geo: a1.max_pool_bwd_plain(x, dy, *geo),
               nbytes)
        del x, y, dy, got
    torch.cuda.empty_cache()
    return rows


def write_thumos_fixture(d: str, n_videos: int = 2, frames: int = 1560,
                         split: str = "thumos14_tag_test") -> str:
    """A THUMOS14 proposal list (the repo's test-fixture format) with
    fg, incomplete and background proposals per video."""
    lines = []
    for v in range(n_videos):
        gt = [(1 + v % 20, 260, 780), (1 + (v + 7) % 20, 1040, 1352)]
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


def main_path(card: str, smi: str, profile: str = None) -> dict:
    """Phases 4 and 5: ssn_test and training at full width, then the
    checks and the timings."""
    import numpy as np
    import torch

    from action_detection_torch.cli.ssn_test import main as ssn_test
    from action_detection_torch.infer.scorer import ProposalScorer
    from action_detection_torch.kernels import (launch_counts,
                                                reset_launch_counts)
    from action_detection_torch.models import SSN, seeded_init
    from action_detection_torch.models.backbones.bn_inception_int8 import (
        _E2EOps, _e2e_stem_quantized, _e2e_trunk, _walk_trunk,
        bninception_int8_e2e_features, tree_to)
    from action_detection_torch.train import save_checkpoint

    with tempfile.TemporaryDirectory() as d:
        write_thumos_fixture(d)
        write_thumos_fixture(d, n_videos=4, split="thumos14_tag_val")
        model = seeded_init(SSN(num_class=20, base_model="BNInception",
                                dropout=0.0), seed=0)
        reg_stats = np.array([[0.01, -0.02], [0.1, 0.2]], np.float32)
        ckpt = os.path.join(d, "ssn_thumos14_BNInception_rgb.pt")
        save_checkpoint(ckpt, model.state_dict(), reg_stats,
                        arch="BNInception")
        out = os.path.join(d, "scores.pkl")
        cli = ["thumos14", "RGB", ckpt, out, "--synthetic_data",
               "--prop_file_dir", d]

        reset_launch_counts()
        t0 = time.perf_counter()
        ssn_test(cli)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the scorer turned TF32 off; the training steps keep it off
        torch.backends.cudnn.allow_tf32 = False
        train = run_training(d)
        launches = launch_counts()
        print(f"main path: ssn_test wall {wall:.2f} s, launches {launches}",
              flush=True)
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"{name} never launched on the main path")

        with open(out, "rb") as f:
            scores = pickle.load(f)
        if len(scores) != 2:
            raise AssertionError(f"expected 2 scored videos, got {len(scores)}")
        for vid, (rel, act, comp, reg) in scores.items():
            P = rel.shape[0]
            if not (act.shape == (P, 21) and comp.shape == (P, 20)
                    and reg.shape == (P, 20, 2)):
                raise AssertionError(f"{vid}: shapes {act.shape} "
                                     f"{comp.shape} {reg.shape}")
            for a in (act, comp, reg):
                if not np.isfinite(a).all():
                    raise AssertionError(f"{vid}: non-finite scores")
        print(f"main path: pickle ok ({len(scores)} videos, "
              f"P={[v[0].shape[0] for v in scores.values()]})", flush=True)

        check_train_step_small(d)
        if profile:
            profile_cli(profile, cli)

    # agreement checks and step timing on a scorer built like the CLI's
    rng = np.random.RandomState(0)
    frames = rng.randint(0, 256, size=(64, 256, 340, 3), dtype=np.uint8)
    spec = model.input_spec
    calib = np.concatenate([frames[:2, 16:240, 58:282]] * 5)   # 10 crops
    scorer = ProposalScorer(model, spec, reg_stats=reg_stats, num_class=20,
                            chunk_frames=64, device="cuda", quantize="e2e",
                            calibration_frames=calib, shared_stem=True)
    qe = scorer._quantized
    crops = torch.as_tensor(frames[:2]).cuda()
    with torch.no_grad():
        from action_detection_torch.data.transforms import (
            device_oversample_normed)

        x = device_oversample_normed(crops, spec)              # (20, 224, 224, 3)
        h = _e2e_stem_quantized(qe, x)
        qe_cpu = tree_to(qe, "cpu")
        got = _walk_trunk(_E2EOps(qe), h).cpu()
        ref = _walk_trunk(_E2EOps(qe_cpu), h.cpu())
        if not torch.equal(got, ref):
            raise AssertionError("int8 trunk on the card differs from the "
                                 "plain kernels on the CPU in "
                                 f"{(got != ref).sum().item()} values")
        # the dequantizing global mean may round differently across devices
        fgot = _e2e_trunk(qe, h).cpu()
        fref = _e2e_trunk(qe_cpu, h.cpu())
        torch.testing.assert_close(fgot, fref, rtol=1e-6, atol=0)
        print("check: int8 trunk activations (K1-K3 on the card) == plain "
              f"versions on the CPU, bit-exact, {tuple(got.shape)}; features "
              f"max |d| {(fgot - fref).abs().max().item()}", flush=True)
        fmodel = model.to("cuda").eval()
        f32 = fmodel.base_model(x).double().cpu()
        q8 = bninception_int8_e2e_features(qe, x).double().cpu()
        cos = torch.nn.functional.cosine_similarity(f32, q8, dim=1).min()
        rel = ((q8 - f32).norm() / f32.norm()).item()
        if not (cos > 0.99 and rel < 0.12):
            raise AssertionError(f"int8 features vs float: cos {cos} rel {rel}")
        print(f"check: int8-e2e vs float BNInception features: min cos "
              f"{cos.item():.6f}, rel rms {rel:.5f}", flush=True)
        model.to("cpu")

    chunk = torch.as_tensor(frames).cuda()
    score_step = lambda: scorer._score_chunk(chunk, 64)      # noqa: E731
    step_ms = _time_ms(score_step, reps=10, warmup=2)
    fscorer = ProposalScorer(model, spec, reg_stats=reg_stats, num_class=20,
                             chunk_frames=64, device="cuda", quantize=False)
    float_ms = _time_ms(lambda: fscorer._score_chunk(chunk, 64), reps=5,
                        warmup=1)
    fscorer.close()
    print(f"step: int8-e2e shared-stem {step_ms:.2f} ms per {SLICE_N}-crop "
          f"step = {SLICE_N / step_ms * 1e3:.0f} crops/s; float32 backbone "
          f"{float_ms:.2f} ms = {SLICE_N / float_ms * 1e3:.0f} crops/s "
          f"({smi})", flush=True)
    train_ms = statistics.median(train["ms"][1:])
    print(f"train: {train_ms:.2f} ms per {TRAIN_N}-image step (median of "
          f"steps 2-{TRAIN_STEPS}, first {train['ms'][0]:.2f} ms) = "
          f"{TRAIN_N / train_ms * 1e3:.0f} images/s, float32, TF32 off "
          f"({smi})", flush=True)
    if profile:
        train_step = lambda: train["step"](train["batch"])    # noqa: E731
        profile_calls(profile, "score_step", score_step, reps=3)
        profile_calls(profile, "train_step", train_step, reps=2)
    scorer.close()
    return launches


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


def profile_cli(out_dir: str, cli) -> None:
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
    with open(_profile_out(out_dir, "ssn_test"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                          row_limit=40))
    print(f"profile ssn_test: wall {wall_us / 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms = {busy / wall_us:.1%}", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    args = sys.argv[1:]
    if args and (args[0] != "--profile" or len(args) != 2):
        print("usage: python3 chip_smoke.py [--profile DIR]", file=sys.stderr)
        return 2
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
    launches = main_path(card, smi, profile)

    sources = {"int8_conv": ("action_detection_torch/csrc/int8_conv.cu",
                             f"{TPU_SRC}:257"),
               "int8_max_pool": ("action_detection_torch/csrc/int8_pool.cu",
                                 f"{TPU_SRC}:230"),
               "int8_avg_pool": ("action_detection_torch/csrc/int8_pool.cu",
                                 f"{TPU_SRC}:244"),
               "max_pool_bwd": ("action_detection_torch/csrc/pool_bwd.cu",
                                "action_detection_tpu/ops/pool_bwd_pallas.py"
                                ":262")}
    kernels = []
    for name, shapes in rows.items():
        src, replaces = sources[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r[1] for r in shapes),
            # summed over the slice shapes checked above
            "ms": sum(r[2] for r in shapes),
            "plain_ms": sum(r[3] for r in shapes)})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
