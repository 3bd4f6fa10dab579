"""SSN trainer: the losses, the train step and the eval step on one device.

Port of ``action_detection_tpu/train/trainer.py``: the loss composition and
the proposal-type subsets are the JAX package's. The per-video proposal
layout is ``[fg | incomplete | bg]`` (1, 6 and 1 rows by config), so each
head's training subset is a static slice (activity: fg + bg, completeness:
fg + incomplete, regression: fg). BatchNorm trains as the model's
``bn_mode`` says; the running statistics of batch-statistic BNs update
after each step's backward (``models/backbones/common.py``). The binary
actionness model's loss (``binary_train``) is plain cross entropy on the
course-segment mean (:func:`make_binary_loss_fn`).

A step takes a uint8 batch from :func:`~..data.pipeline.assemble_train_batch`
(moved to the device with :func:`batch_to_device`); preprocessing runs on
the device. Its backward runs every max pool of the float backbone through
the hand-written kernel A1 (``ops/pooling.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import SamplingConfig
from ..data.transforms import preprocess_frames
from ..models.backbones.common import commit_batch_stats
from ..ops.losses import (accuracy, activity_cross_entropy,
                          classwise_regression_loss, completeness_loss)
from .optim import SSNOptimizer


def float32_convs_and_matmuls() -> None:
    """Turn TF32 off for cuDNN convolutions and CUDA matmuls, process-wide.

    Float32 is what the JAX package's parity holds (f32 convs, heads at
    ``Precision.HIGHEST``) and what every training number on record used;
    the training CLIs call this at the start of ``main``. The fast option
    is ``--bf16``, not TF32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class LossWeights:
    comp: float = 0.1     # --comp_loss_weight
    reg: float = 0.1      # --reg_loss_weight
    ohem_ratio: float = 0.17


def subset_slices(sampling: SamplingConfig):
    """Static per-video row ranges for the three heads' training subsets."""
    fg = sampling.fg_per_video
    inc = sampling.incomplete_per_video
    p = sampling.prop_per_video
    return {"act": ((0, fg), (fg + inc, p)),   # fg rows + bg rows
            "comp": (0, fg + inc),             # fg + incomplete rows
            "reg": (0, fg)}                    # fg rows


def select_head_subsets(per_video: torch.Tensor, sampling: SamplingConfig,
                        head: str) -> torch.Tensor:
    """Slice (B, P, ...) per-video arrays to a head's subset, flattened."""
    sl = subset_slices(sampling)
    if head == "act":
        (a0, a1), (b0, b1) = sl["act"]
        sub = torch.cat([per_video[:, a0:a1], per_video[:, b0:b1]], dim=1)
    elif head in ("comp", "reg"):
        lo, hi = sl[head]
        sub = per_video[:, lo:hi]
    else:
        raise ValueError(head)
    return sub.reshape((-1,) + tuple(sub.shape[2:]))


def batch_to_device(batch: Dict[str, np.ndarray],
                    device) -> Dict[str, torch.Tensor]:
    """Host batch (numpy) -> tensors on ``device`` (frames stay uint8)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def make_loss_fn(model: nn.Module, sampling: SamplingConfig,
                 weights: LossWeights = LossWeights()):
    """The full SSN loss over one uint8 batch (preprocessing on device,
    with the model's input spec and modality).

    ``loss_fn(batch, train, generator)`` returns ``(total, metrics)``; it
    sets the model's mode (``train`` enables the head dropout).
    """
    P = sampling.prop_per_video
    new_length = model.resolved_new_length

    def loss_fn(batch: Dict[str, torch.Tensor], train: bool = True,
                generator: Optional[torch.Generator] = None):
        model.train(train)
        frames = preprocess_frames(batch["frames"], model.input_spec,
                                   model.modality, new_length)
        act, comp, reg = model(frames, batch["scaling"], generator)

        B = act.shape[0] // P
        labels = batch["labels"].reshape(B, P)
        act_out = select_head_subsets(act.reshape(B, P, -1), sampling, "act")
        act_target = select_head_subsets(labels, sampling, "act")
        comp_out = select_head_subsets(comp.reshape(B, P, -1), sampling,
                                       "comp")
        comp_target = select_head_subsets(labels, sampling, "comp")

        act_loss = activity_cross_entropy(act_out, act_target)
        comp_loss = completeness_loss(
            comp_out, comp_target, sample_split=sampling.fg_per_video,
            sample_group_size=(sampling.fg_per_video
                               + sampling.incomplete_per_video),
            ohem_ratio=weights.ohem_ratio)
        total = act_loss + weights.comp * comp_loss
        metrics = {"act_loss": act_loss, "comp_loss": comp_loss}
        if reg is not None:
            reg_out = select_head_subsets(
                reg.reshape(B, P, reg.shape[-2], 2), sampling, "reg")
            reg_target = select_head_subsets(
                batch["reg_targets"].reshape(B, P, 2), sampling, "reg")
            reg_labels = select_head_subsets(labels, sampling, "reg")
            reg_loss = classwise_regression_loss(reg_out, reg_labels,
                                                 reg_target)
            total = total + weights.reg * reg_loss
            metrics["reg_loss"] = reg_loss

        # fg/bg accuracy over the [fg..., bg...] activity subset layout
        n_fg = sampling.fg_per_video
        n_actsub = n_fg + sampling.bg_per_video
        act_g = act_out.reshape(B, n_actsub, -1)
        tgt_g = act_target.reshape(B, n_actsub)
        metrics["act_acc"] = accuracy(act_out, act_target)
        metrics["fg_acc"] = accuracy(act_g[:, :n_fg].reshape(-1, act_g.shape[-1]),
                                     tgt_g[:, :n_fg].reshape(-1))
        metrics["bg_acc"] = accuracy(act_g[:, n_fg:].reshape(-1, act_g.shape[-1]),
                                     tgt_g[:, n_fg:].reshape(-1))
        metrics["loss"] = total
        return total, metrics

    return loss_fn


def make_binary_loss_fn(model: nn.Module):
    """The binary actionness loss: softmax cross entropy of the
    course-segment-mean logits against the fg/bg labels, and the accuracy
    (``loss_fn(batch, train, generator) -> (loss, metrics)``)."""
    new_length = model.resolved_new_length

    def loss_fn(batch: Dict[str, torch.Tensor], train: bool = True,
                generator: Optional[torch.Generator] = None):
        model.train(train)
        frames = preprocess_frames(batch["frames"], model.input_spec,
                                   model.modality, new_length)
        logits = model(frames, generator)
        loss = F.cross_entropy(logits, batch["labels"])
        return loss, {"loss": loss, "acc": accuracy(logits, batch["labels"])}

    return loss_fn


def make_train_step(model: nn.Module, optimizer: SSNOptimizer,
                    sampling: Optional[SamplingConfig] = None,
                    weights: LossWeights = LossWeights(), seed: int = 0,
                    loss_fn=None):
    """One SGD mini-step: ``train_step(batch) -> metrics`` (device tensors).

    The loss is the SSN's over ``sampling`` unless ``loss_fn`` is given
    (``make_binary_loss_fn``). The optimizer applies an update on every
    ``iter_size``-th call. The head dropout draws from a
    ``torch.Generator`` seeded with ``seed`` on the model's device,
    advanced by every step.
    """
    loss_fn = loss_fn or make_loss_fn(model, sampling, weights)
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad()
        total, metrics = loss_fn(batch, True, generator)
        total.backward()
        commit_batch_stats(model)
        # gradient norm over every parameter, frozen BN included (the JAX
        # package's optax.global_norm of the whole gradient tree)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_eval_step(model: nn.Module,
                   sampling: Optional[SamplingConfig] = None,
                   weights: LossWeights = LossWeights(), loss_fn=None):
    """The loss and metrics of one batch under ``no_grad``, dropout off and
    BatchNorm on its running statistics: ``eval_step(batch) -> metrics``."""
    loss_fn = loss_fn or make_loss_fn(model, sampling, weights)

    def eval_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            _, metrics = loss_fn(batch, False)
        return metrics

    return eval_step
