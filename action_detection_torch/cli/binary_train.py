"""Binary actionness training CLI (torch port of
``action_detection_tpu/cli/binary_train.py``).

Usage: python -m action_detection_torch.cli.binary_train <dataset>
       <modality> [flags]

Trains the TAG fg/bg classifier (``models/binary.py:BinaryClassifier``):
batches of 4 videos x 12 proposals (3 fg : 9 bg) x 5 course segments by
default, plain cross entropy on the course-segment mean. The JAX CLI's
loop: a ``RandomState(seed * 1000 + epoch)`` shuffle, per-step seeds,
balanced 6:6 validation every ``--eval-freq`` epochs when the validation
list exists, and ``ssn_<dataset>_<arch>_<modality>_binary_checkpoint.pt``
(``reg_stats`` of zeros) every epoch, which the port's ``binary_test``
reads. Same flags as ``ssn_train`` (``--tem`` is accepted and unused, as in
the JAX CLI). ``main`` returns the run's
:class:`~.train_common.RunStats`.
"""

from __future__ import annotations

import os

import numpy as np


def main(argv=None):
    from .opts import build_train_parser
    from .train_common import setup

    parser = build_train_parser("Train binary actionness classifier "
                                "(PyTorch)")
    parser.set_defaults(batch_size=4)
    args = parser.parse_args(argv)
    device = setup(args, "binary_train")

    import torch

    from ..config import get_actionness_configs
    from ..data.binary_dataset import BinaryDataset
    from ..data.pipeline import PrefetchLoader, assemble_binary_batch
    from ..data.transforms import (Compose, GroupCenterCrop, GroupScale,
                                   get_train_augmentation)
    from ..models import BinaryClassifier, seeded_init
    from ..train import (batch_to_device, checkpoint_name, load_checkpoint,
                         make_binary_loss_fn, make_eval_step, make_optimizer,
                         make_train_step, save_checkpoint)
    from ..train.init_weights import apply_init_weights
    from .train_common import RunStats, frame_provider, run_epoch

    cfg = get_actionness_configs(args.dataset)
    # the head is as wide as the actionness config says (2 for thumos14, 100
    # for activitynet1.2); the targets stay 0/1 fg/bg either way
    model = BinaryClassifier(num_class=cfg.num_class,
                             course_segment=args.num_body_segments,
                             modality=args.modality, base_model=args.arch,
                             dropout=args.dropout, bn_mode=args.bn_mode,
                             dtype=torch.bfloat16 if args.bf16
                             else torch.float32)
    seeded_init(model, args.seed)
    spec = model.input_spec
    new_length = model.resolved_new_length

    train_ds = BinaryDataset(
        os.path.join(args.prop_file_dir, f"{cfg.train_list}_proposal_list.txt"),
        body_seg=args.num_body_segments, new_length=new_length, verbose=True)
    val_file = os.path.join(args.prop_file_dir,
                            f"{cfg.test_list}_proposal_list.txt")
    # validation samples a balanced 6:6 fg/bg split
    val_ds = (BinaryDataset(val_file, body_seg=args.num_body_segments,
                            new_length=new_length, fg_ratio=6, bg_ratio=6)
              if os.path.exists(val_file) else None)
    provider = frame_provider(args)
    augmentation = get_train_augmentation(spec.input_size, args.modality)
    eval_transform = Compose([GroupScale(spec.scale_size),
                              GroupCenterCrop(spec.input_size)])

    resume_ck = (load_checkpoint(args.resume)
                 if args.resume and os.path.isfile(args.resume) else None)
    start_epoch = (int(resume_ck["epoch"]) if resume_ck is not None
                   else args.start_epoch)

    apply_init_weights(model, args, cfg)
    stats = RunStats()
    if resume_ck is not None:
        model.load_state_dict(resume_ck["state_dict"])
        stats.best_loss = resume_ck["best_loss"]
        print(f"=> resumed from '{args.resume}' (epoch {start_epoch})")
    model.to(device)

    steps_per_epoch = max(len(train_ds) // args.batch_size, 1)
    optimizer = make_optimizer(
        model, base_lr=args.lr, lr_steps=args.lr_steps,
        steps_per_epoch=steps_per_epoch, momentum=args.momentum,
        weight_decay=args.weight_decay, clip_gradient=args.clip_gradient,
        iter_size=args.iter_size, start_epoch=start_epoch)
    loss_fn = make_binary_loss_fn(model)
    train_step = make_train_step(model, optimizer, seed=args.seed,
                                 loss_fn=loss_fn)
    eval_step = make_eval_step(model, loss_fn=loss_fn)
    stats.lr_factor, count0 = optimizer.lr_factor(), optimizer.count

    def validate():
        v_rng = np.random.RandomState(999)
        n_val = max(len(val_ds.video_list) // args.batch_size, 1)
        losses, accs = [], []
        for i in range(n_val):
            idxs = [(i * args.batch_size + j) % len(val_ds.video_list)
                    for j in range(args.batch_size)]
            vb = assemble_binary_batch(val_ds, idxs, provider, eval_transform,
                                       v_rng, random_shift=False)
            m = eval_step(batch_to_device(vb, device))
            losses.append(float(m["loss"]))
            accs.append(float(m["acc"]))
        stats.val_losses.append(float(np.mean(losses)))
        return float(np.mean(losses)), float(np.mean(accs))

    def line(bank) -> str:
        return f"Loss {bank['loss']:.4f} Acc {bank['acc']:.2f}"

    ckpt_file = checkpoint_name(args.snapshot_pref, args.dataset, args.arch,
                                args.modality, "binary_checkpoint.pt")
    order = np.arange(len(train_ds))
    for epoch in range(start_epoch, args.epochs):
        ep_rng = np.random.RandomState(args.seed * 1000 + epoch)
        ep_rng.shuffle(order)
        # drawn single-threaded: batches are made on the loader's threads
        step_seeds = ep_rng.randint(2 ** 31, size=steps_per_epoch)

        def make_batch(i, step_seeds=step_seeds):
            idxs = order[(i * args.batch_size) % len(order):][:args.batch_size]
            if len(idxs) < args.batch_size:
                idxs = np.concatenate([idxs,
                                       order[:args.batch_size - len(idxs)]])
            return assemble_binary_batch(
                train_ds, idxs, provider, augmentation,
                np.random.RandomState(step_seeds[i]))

        loader = PrefetchLoader(make_batch, steps_per_epoch,
                                num_threads=args.workers)
        run_epoch(epoch, loader, steps_per_epoch, train_step, device, args,
                  stats, line,
                  trace=bool(args.trace_dir) and epoch == start_epoch)

        is_best = False
        if val_ds is not None and (epoch + 1) % max(args.eval_freq, 1) == 0:
            val_loss, val_acc = validate()
            is_best = val_loss < stats.best_loss
            stats.best_loss = min(stats.best_loss, val_loss)
            print(f"Validation: Loss {val_loss:.4f} Acc {val_acc:.2f} "
                  f"(best {stats.best_loss:.4f})", flush=True)
        save_checkpoint(ckpt_file, model.state_dict(), np.zeros((2, 2)),
                        arch=args.arch, epoch=epoch + 1,
                        best_loss=stats.best_loss, is_best=is_best)
        print(f"checkpoint saved to {ckpt_file} (best={is_best})", flush=True)
    stats.updates = optimizer.count - count0
    print(f"train: {stats.summary()} on {device}", flush=True)
    return stats


if __name__ == "__main__":
    main()
