"""What ``ssn_train`` and ``binary_train`` share: the set-up every run does
first, the frame provider, and one epoch of train steps with its meters,
step timing and optional trace."""

from __future__ import annotations

import time
from typing import Callable, Dict, List

import numpy as np


def setup(args, cli: str):
    """Refuse what the port does not cover, turn TF32 off (the trainers'
    float32, ``train/trainer.py:float32_convs_and_matmuls``) and resolve the
    device (a CUDA device with no card raises). Returns the device."""
    from ..infer.features import resolve_device
    from ..train import float32_convs_and_matmuls
    from .unported import refuse_unported_training

    refuse_unported_training(args, cli)
    float32_convs_and_matmuls()
    device = resolve_device(args.device)
    if args.devices and device.type == "cuda":
        device = resolve_device(f"cuda:{args.devices[0]}")
    return device


def frame_provider(args):
    """Synthetic frames (``--synthetic_data``) or JPEGs under
    ``--data_root`` (``img_*`` for RGB, ``<flow_prefix>{x,y}_*`` for Flow)."""
    from ..data.pipeline import DirectoryFrameProvider, SyntheticFrameProvider

    if args.synthetic_data:
        return SyntheticFrameProvider(modality=args.modality)
    tmpl = ("img_{:05d}.jpg" if args.modality == "RGB"
            else args.flow_prefix + "{}_{:05d}.jpg")
    return DirectoryFrameProvider(args.data_root, tmpl, args.modality)


class RunStats:
    """What a training run measured, returned by the CLIs' ``main``:
    ``step_ms`` (each train step's device time), ``batch_s`` (host seconds
    assembling each batch, on the loader's threads), ``wait_s`` (seconds the
    loop waited for a batch), ``images`` (backbone images a step),
    ``val_losses``, ``best_loss``, ``lr_factor`` (the LR decay the run
    started at) and ``updates`` (optimizer updates applied)."""

    def __init__(self):
        self.step_ms: List[float] = []
        self.batch_s: List[float] = []
        self.wait_s = 0.0
        self.images = 0
        self.val_losses: List[float] = []
        self.best_loss = float("inf")
        self.lr_factor = 1.0
        self.updates = 0

    def summary(self) -> str:
        """One line: the median step from the second on, images/s, host
        seconds a batch."""
        if not self.step_ms:
            return "no train steps"
        steady = self.step_ms[1:] or self.step_ms
        med = float(np.median(steady))
        return (f"{len(self.step_ms)} steps of {self.images} images: median "
                f"step {med:.2f} ms (steps 2 on) = "
                f"{self.images / med * 1e3:.0f} images/s; host assembly "
                f"{np.mean(self.batch_s):.3f} s a batch, loop waited "
                f"{self.wait_s:.2f} s for batches")


def run_epoch(epoch: int, loader, steps: int, train_step: Callable,
              device, args, stats: RunStats, line: Callable[[Dict], str],
              trace: bool) -> None:
    """One epoch: each batch to the device, one train step (timed on the
    device), metrics fetched and printed only at ``--print-freq`` ticks (a
    fetch synchronizes); with ``trace`` the second step runs under
    ``device_trace(--trace_dir)`` and is not printed."""
    from ..train import batch_to_device
    from ..utils.meters import MeterBank, StepTimer, device_trace

    bank = MeterBank()
    timer = StepTimer(device)
    t0 = time.time()
    t_wait = time.perf_counter()
    for i, batch in enumerate(loader):
        stats.wait_s += time.perf_counter() - t_wait
        stats.images = int(np.prod(batch["frames"].shape[:2]))
        db = batch_to_device(batch, device)
        if trace and i == 1:
            with device_trace(args.trace_dir), timer.step():
                train_step(db)
            t_wait = time.perf_counter()
            continue
        with timer.step():
            metrics = train_step(db)
        if i % args.print_freq == 0:
            bank.update({k: float(v) for k, v in metrics.items()})
            print(f"Epoch: [{epoch}][{i}/{steps}] "
                  f"Time {(time.time() - t0) / (i + 1):.3f} " + line(bank),
                  flush=True)
        t_wait = time.perf_counter()
    stats.step_ms += timer.ms()
    stats.batch_s += loader.batch_seconds
