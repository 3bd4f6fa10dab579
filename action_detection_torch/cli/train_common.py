"""What ``ssn_train`` and ``binary_train`` share: the launch of one rank per
device (data parallel, ``launch``), the frame provider, and one epoch of
train steps with its meters, step timing and optional trace."""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List

import numpy as np


def multihost(args) -> bool:
    """Whether the multi-host flags ask to join a job of several processes.
    They go together, and ``--process_id`` is below ``--num_processes``."""
    flags = (args.coordinator_address, args.num_processes, args.process_id)
    if all(f is None for f in flags):
        return False
    if any(f is None for f in flags):
        raise SystemExit("the multi-host flags go together: "
                         "--coordinator_address, --num_processes and "
                         "--process_id")
    if not 0 <= args.process_id < args.num_processes:
        raise SystemExit(f"--process_id {args.process_id} is not below "
                         f"--num_processes {args.num_processes}")
    return True


def launch(args, run: Callable, cli: str):
    """Run a training CLI on its devices: ``run(args, device, rank, world)``
    on every rank this process drives; returns rank 0's result here (this
    process's first rank's in a multi-host job).

    The devices are ``--device`` and ``--gpus`` (``parallel/mesh.py:
    cli_devices``: a CUDA device with no card raises). One device and no
    multi-host flags: one rank, no process group. Otherwise one rank per
    device joins a process group (NCCL on CUDA, gloo on the CPU) of
    ``--num_processes`` x devices ranks through ``--coordinator_address``
    (on one host, a free local port); each rank's global rank is
    ``process_id * devices + local index``. Several local devices start one
    process per device with ``torch.multiprocessing.spawn`` (CUDA is not
    initialized here first); a rank that fails makes this raise.
    """
    from ..parallel import cli_devices, free_port

    multi = multihost(args)
    devices = cli_devices(args.device, args.devices)
    if not multi and len(devices) == 1:
        return run_rank(0, run, args, devices, None, 1, 0)
    n_proc, proc_id = ((args.num_processes, args.process_id) if multi
                       else (1, 0))
    address = (args.coordinator_address if multi
               else f"127.0.0.1:{free_port()}")
    world = n_proc * len(devices)
    print(f"{cli}: rank(s) {proc_id * len(devices)}.."
          f"{(proc_id + 1) * len(devices) - 1} of {world} on "
          f"{[str(d) for d in devices]}, coordinator {address}", flush=True)
    if len(devices) == 1:
        return run_rank(0, run, args, devices, address, world, proc_id)
    import pickle
    import tempfile

    import torch.multiprocessing as mp

    fd, result = tempfile.mkstemp(suffix=".pkl")
    os.close(fd)
    try:
        mp.spawn(run_rank, args=(run, args, devices, address, world,
                                 proc_id, result),
                 nprocs=len(devices), join=True)
        with open(result, "rb") as f:
            return pickle.load(f)
    finally:
        os.remove(result)


def run_rank(local_index: int, run: Callable, args, devices, address,
             world: int, process_id: int, result: str = None):
    """One rank: its device current, TF32 off (``train/trainer.py:
    float32_convs_and_matmuls``), the process group joined when ``address``
    is given (and left at the end), then ``run``. The first local rank
    pickles its result to ``result`` when given (a spawned rank's way
    back)."""
    import torch

    from ..parallel import default_backend, global_rank, initialize_multihost
    from ..train import float32_convs_and_matmuls

    device = devices[local_index]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    float32_convs_and_matmuls()
    rank = global_rank(process_id, len(devices), local_index)
    if address is None:
        return run(args, device, 0, 1)
    import torch.distributed as dist

    initialize_multihost(address, world, rank, default_backend(device))
    try:
        out = run(args, device, rank, world)
    finally:
        dist.destroy_process_group()
    if result is not None and local_index == 0:
        import pickle

        with open(result, "wb") as f:
            pickle.dump(out, f)
    return out


def finish(stats: RunStats, device, rank: int, world: int) -> None:
    """The run's last line: its summary on the device; in a job of several
    ranks every rank prints it, with its rank and its losses (equal on
    every rank)."""
    if world == 1:
        print(f"train: {stats.summary()} on {device}", flush=True)
    else:
        print(f"train (rank {rank} of {world}): {stats.summary()} on "
              f"{device}; losses {stats.losses}", flush=True)


def local_batch(args, world: int) -> int:
    """The videos of a batch each rank assembles: ``-b`` over the ranks,
    which must divide it (the JAX CLIs' assert)."""
    local_bs = args.batch_size // world
    assert local_bs * world == args.batch_size, (args.batch_size, world)
    return local_bs


def frame_provider(args):
    """Synthetic frames (``--synthetic_data``) or JPEGs under
    ``--data_root`` (``img_*`` for RGB and RGBDiff, ``<flow_prefix>{x,y}_*``
    for Flow)."""
    from ..data.pipeline import (DirectoryFrameProvider,
                                 SyntheticFrameProvider, frame_template)

    if args.synthetic_data:
        return SyntheticFrameProvider(modality=args.modality)
    return DirectoryFrameProvider(
        args.data_root, frame_template(args.modality, args.flow_prefix),
        args.modality)


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
        self.losses: List[float] = []

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
              trace: bool, verbose: bool = True) -> None:
    """One epoch: each batch to the device, one train step (timed on the
    device), metrics fetched (into ``stats.losses``) and printed only at
    ``--print-freq`` ticks (a fetch synchronizes), printed only when
    ``verbose`` (rank 0); with ``trace`` the second step runs under
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
            stats.losses.append(float(metrics["loss"]))
            if verbose:
                print(f"Epoch: [{epoch}][{i}/{steps}] "
                      f"Time {(time.time() - t0) / (i + 1):.3f} "
                      + line(bank), flush=True)
        t_wait = time.perf_counter()
    stats.step_ms += timer.ms()
    stats.batch_s += loader.batch_seconds
