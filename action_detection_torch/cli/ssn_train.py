"""SSN training CLI (torch port of ``action_detection_tpu/cli/ssn_train.py``).

Usage: python -m action_detection_torch.cli.ssn_train <dataset> <modality>
       [flags]

The JAX CLI's loop, flags and defaults: a ``RandomState(seed * 1000 +
epoch)`` shuffle and per-step seeds each epoch, batches over
``np.tile(order, 2)``, so the host batches are the JAX CLI's byte for byte;
validation (scale + center crop) every
``--eval-freq`` epochs and at the last; a ``.pt`` checkpoint with
``reg_stats`` and ``best_loss`` plus its ``model_best`` copy; ``--resume``
(a missing file is ignored), ``--evaluate``, ``--init_weights``,
``--iter_size``, ``--bn_mode``, ``--bf16`` and ``--remat``. TF32 is off.
Every max pool's backward runs on the hand-written kernel A1. ``main``
returns the run's :class:`~.train_common.RunStats` (rank 0's).

Data parallel (``cli/train_common.py:launch``): ``--gpus 0 1 ...`` trains
one rank per GPU under ``DistributedDataParallel``; ``--coordinator_address
host:port --num_processes N --process_id i`` joins a job across hosts. Each
rank assembles its slice of each global batch as the JAX CLI's
multi-process code does (``-b`` over the ranks, which must divide it; the
step's ``RandomState(step_seeds[i])`` in every rank); only rank 0 prints the
step lines and writes checkpoints; every rank restores ``--resume``.
"""

from __future__ import annotations

import os

import numpy as np


def main(argv=None):
    from .opts import build_train_parser
    from .train_common import launch

    args = build_train_parser(
        "Train Structured Segment Networks (PyTorch)").parse_args(argv)
    return launch(args, train, "ssn_train")


def batch_maker(train_ds, provider, augmentation, batch_order: np.ndarray,
                step_seeds: np.ndarray, batch_size: int, mine: slice):
    """``make_batch(i)``: this rank's slice ``mine`` of the ``i``-th global
    batch of ``batch_order``, augmented with ``RandomState(step_seeds[i])``,
    as the JAX CLI's multi-process code assembles it."""
    from ..data.pipeline import assemble_train_batch

    def make_batch(i: int):
        idxs = batch_order[i * batch_size:(i + 1) * batch_size][mine]
        return assemble_train_batch(train_ds, idxs, provider, augmentation,
                                    np.random.RandomState(step_seeds[i]))

    return make_batch


def train(args, device, rank: int, world: int):
    """The training run of one rank of ``world`` on ``device``."""
    import torch

    from ..config import get_configs
    from ..data.pipeline import PrefetchLoader, assemble_train_batch
    from ..data.ssn_dataset import SSNDataset
    from ..data.transforms import (Compose, GroupCenterCrop, GroupScale,
                                   get_train_augmentation)
    from ..models import SSN, seeded_init
    from ..train import (LossWeights, batch_to_device, checkpoint_name,
                         load_checkpoint, make_eval_step, make_optimizer,
                         make_train_step, save_checkpoint)
    from ..parallel import wrap_ddp
    from ..train.init_weights import apply_init_weights
    from .train_common import (RunStats, finish, frame_provider, local_batch,
                               run_epoch)

    cfg = get_configs(args.dataset)
    model = SSN(num_class=cfg.num_class,
                starting_segment=args.num_aug_segments,
                course_segment=args.num_body_segments,
                ending_segment=args.num_aug_segments,
                modality=args.modality, base_model=args.arch,
                dropout=args.dropout, stpp_cfg=cfg.stpp, bn_mode=args.bn_mode,
                dtype=torch.bfloat16 if args.bf16 else torch.float32,
                remat=args.remat)
    seeded_init(model, args.seed)
    spec = model.input_spec
    new_length = model.resolved_new_length

    train_ds = SSNDataset(
        os.path.join(args.prop_file_dir, f"{cfg.train_list}_proposal_list.txt"),
        cfg.sampling, new_length=new_length, body_seg=args.num_body_segments,
        aug_seg=args.num_aug_segments,
        epoch_multiplier=args.training_epoch_multiplier, verbose=rank == 0)
    val_ds = SSNDataset(
        os.path.join(args.prop_file_dir, f"{cfg.test_list}_proposal_list.txt"),
        cfg.sampling, new_length=new_length, body_seg=args.num_body_segments,
        aug_seg=args.num_aug_segments, reg_stats=train_ds.stats,
        verbose=rank == 0)
    provider = frame_provider(args)
    augmentation = get_train_augmentation(spec.input_size, args.modality)
    # validation: scale + center crop, no random shift
    eval_transform = Compose([GroupScale(spec.scale_size),
                              GroupCenterCrop(spec.input_size)])

    # the LR step decay follows the ABSOLUTE epoch: peek at the resume
    # checkpoint before building the optimizer
    resume_ck = (load_checkpoint(args.resume)
                 if args.resume and os.path.isfile(args.resume) else None)
    start_epoch = (int(resume_ck["epoch"]) if resume_ck is not None
                   else args.start_epoch)

    apply_init_weights(model, args, cfg)
    stats = RunStats()
    if resume_ck is not None:
        model.load_state_dict(resume_ck["state_dict"])
        stats.best_loss = resume_ck["best_loss"]
        if rank == 0:
            print(f"=> resumed from '{args.resume}' (epoch {start_epoch})")
    model.to(device)
    ddp = wrap_ddp(model, device)

    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    optimizer = make_optimizer(
        model, base_lr=args.lr, lr_steps=args.lr_steps,
        steps_per_epoch=steps_per_epoch, momentum=args.momentum,
        weight_decay=args.weight_decay, clip_gradient=args.clip_gradient,
        iter_size=args.iter_size, start_epoch=start_epoch)
    weights = LossWeights(comp=args.comp_loss_weight, reg=args.reg_loss_weight)
    train_step = make_train_step(ddp, optimizer, cfg.sampling, weights,
                                 seed=args.seed)
    eval_step = make_eval_step(model, cfg.sampling, weights)
    stats.lr_factor, count0 = optimizer.lr_factor(), optimizer.count
    # each rank assembles its slice of every global batch
    local_bs = local_batch(args, world)
    mine = slice(rank * local_bs, (rank + 1) * local_bs)

    def validate() -> float:
        v_rng = np.random.RandomState(12345)
        n_val = max(len(val_ds) // args.batch_size, 1)
        losses = []
        for i in range(n_val):
            idxs = [(i * args.batch_size + j) % len(val_ds.video_list)
                    for j in range(args.batch_size)][mine]
            batch = assemble_train_batch(val_ds, idxs, provider,
                                         eval_transform, v_rng,
                                         random_shift=False)
            metrics = eval_step(batch_to_device(batch, device))
            losses.append(float(metrics["loss"]))
            if i % args.print_freq == 0 and rank == 0:
                print(f"Test: [{i}/{n_val}] Loss {losses[-1]:.4f} "
                      f"Act acc {float(metrics['act_acc']):.2f} "
                      f"FG {float(metrics['fg_acc']):.2f} "
                      f"BG {float(metrics['bg_acc']):.2f}", flush=True)
        avg = float(np.mean(losses))
        if rank == 0:
            print(f"Testing Results: Loss {avg:.5f}", flush=True)
        stats.val_losses.append(avg)
        return avg

    if args.evaluate:
        validate()
        return stats

    def line(bank) -> str:
        return (f"Loss {bank['loss']:.4f} Act {bank['act_loss']:.3f} "
                f"Comp {bank['comp_loss']:.3f} Reg {bank['reg_loss']:.3f} "
                f"FG {bank['fg_acc']:.2f} BG {bank['bg_acc']:.2f}")

    ckpt_file = checkpoint_name(args.snapshot_pref, args.dataset, args.arch,
                                args.modality)
    order = np.arange(len(train_ds))
    for epoch in range(start_epoch, args.epochs):
        epoch_rng = np.random.RandomState(args.seed * 1000 + epoch)
        epoch_rng.shuffle(order)
        batch_order = np.tile(order, 2)[:steps_per_epoch * args.batch_size]
        # drawn here, single-threaded: the batches are made on the loader's
        # threads, and a shared RandomState is not thread-safe
        step_seeds = epoch_rng.randint(2 ** 31, size=steps_per_epoch)

        loader = PrefetchLoader(
            batch_maker(train_ds, provider, augmentation, batch_order,
                        step_seeds, args.batch_size, mine),
            steps_per_epoch, num_threads=args.workers)
        run_epoch(epoch, loader, steps_per_epoch, train_step, device, args,
                  stats, line, trace=(bool(args.trace_dir) and rank == 0
                                      and epoch == start_epoch),
                  verbose=rank == 0)

        if (epoch + 1) % args.eval_freq == 0 or epoch == args.epochs - 1:
            # the validation loss is the ranks' mean: every rank agrees on
            # best_loss
            loss = validate()
            is_best = loss < stats.best_loss
            stats.best_loss = min(loss, stats.best_loss)
            if rank == 0:
                save_checkpoint(ckpt_file, model.state_dict(),
                                train_ds.stats, arch=args.arch,
                                epoch=epoch + 1, best_loss=stats.best_loss,
                                is_best=is_best)
                print(f"checkpoint saved to {ckpt_file} (best={is_best})",
                      flush=True)
    stats.updates = optimizer.count - count0
    finish(stats, device, rank, world)
    return stats


if __name__ == "__main__":
    main()
