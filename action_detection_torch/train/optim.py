"""Optimizer: SGD with the reference's five parameter-group policy.

Port of ``action_detection_tpu/train/optim.py``:

  group              lr_mult  decay_mult
  first_conv_weight     1         1
  first_conv_bias       2         0
  normal_weight         1         1
  normal_bias           2         0
  bn (scale/shift)      frozen — never updated

with the step-decay schedule ``lr = base * 0.1^(#epoch boundaries passed)``
and an optional global-norm gradient clip that leaves the frozen BN
parameters out (optax's ``clip_by_global_norm``: ``g / norm * max`` once the
norm reaches ``max``).
``torch.optim.SGD`` (momentum, no dampening, weight decay added to the
gradient) is the same update as the JAX package's optax chain:
``u = g + wd*p; m = u + momentum*m; p -= lr*m``.

``iter_size`` k is ``optax.MultiSteps``: the gradients of k mini-steps are
averaged (its running mean ``acc += (g - acc) / (i + 1)``), and the k-th
call clips, decays and applies that average; parameters and momentum do
not move in between. The schedule counts applied updates, so an epoch is
``steps_per_epoch // iter_size`` of them, and ``start_epoch`` starts it at
that epoch's count (a resumed run starts decayed). A resume restarts the
momentum at zero: the checkpoints hold no optimizer state, as in the JAX
package.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

# the first convolution of each backbone, by its path in the backbone
# (cross-modality finetuning gives it its own lr/decay multipliers):
# BNInception, InceptionV3, ResNet, VGG
FIRST_CONV_NAMES = ("conv1_7x7_s2", "Conv2d_1a_3x3.conv", "conv1",
                    "features.0")

_MULTS = {"first_conv_weight": (1.0, 1.0), "first_conv_bias": (2.0, 0.0),
          "normal_weight": (1.0, 1.0), "normal_bias": (2.0, 0.0)}


def label_param(name: str, module: nn.Module) -> str:
    """The optimization group of one parameter, from its module: BN
    layers by type, whatever their name (VGG's ``features.1`` is one); the
    first conv only at the backbone's top level (``conv1`` also names a
    conv in every ResNet block)."""
    layer, _, leaf = name.rpartition(".")
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return "bn_frozen"
    first = (layer[len("base_model."):] if layer.startswith("base_model.")
             else layer) in FIRST_CONV_NAMES
    if leaf == "bias":
        return "first_conv_bias" if first else "normal_bias"
    return "first_conv_weight" if first else "normal_weight"


def label_params(model: nn.Module) -> Dict[str, str]:
    """``{parameter name: group}`` over the whole model."""
    modules = dict(model.named_modules())
    return {name: label_param(name, modules[name.rpartition(".")[0]])
            for name, _ in model.named_parameters()}


def _decay_f32(n: int) -> np.float32:
    """``0.1 ** n`` as the JAX schedule computes it in float32: XLA's pow
    with an integer exponent, by binary exponentiation. The decayed LRs are
    then the JAX optimizer's to the bit; undecayed ones are the base LRs,
    which torch rounds to float32 itself."""
    r, b = np.float32(1.0), np.float32(0.1)
    while n:
        if n & 1:
            r = np.float32(r * b)
        b = np.float32(b * b)
        n >>= 1
    return r


class SSNOptimizer:
    """SGD over the trainable groups + step-decay LR + optional clip, with
    ``iter_size`` gradient accumulation."""

    def __init__(self, model: nn.Module, base_lr: float,
                 lr_steps: Sequence[float], steps_per_epoch: int,
                 momentum: float = 0.9, weight_decay: float = 5e-4,
                 clip_gradient: Optional[float] = None, iter_size: int = 1,
                 start_epoch: int = 0):
        labels = label_params(model)
        groups: List[dict] = []
        for g, (lr_mult, decay_mult) in _MULTS.items():
            params = [p for n, p in model.named_parameters()
                      if labels[n] == g]
            if params:
                groups.append({"params": params, "name": g,
                               "lr": base_lr * lr_mult,
                               "weight_decay": weight_decay * decay_mult})
        self.sgd = torch.optim.SGD(groups, lr=base_lr, momentum=momentum,
                                   dampening=0.0, nesterov=False)
        self.iter_size = max(int(iter_size), 1)
        effective = max(steps_per_epoch // self.iter_size, 1)
        self.boundaries = (np.asarray(sorted(lr_steps), np.float64)
                           * effective)
        self.count = start_epoch * effective
        self.mini_step = 0
        self._acc: Optional[List[torch.Tensor]] = None
        self.clip_gradient = clip_gradient
        self._base = [g["lr"] for g in self.sgd.param_groups]
        self._set_lr()

    def decays(self) -> int:
        """LR boundaries passed so far."""
        return int(np.sum(self.count >= self.boundaries))

    def lr_factor(self) -> float:
        return 0.1 ** self.decays()

    def _set_lr(self) -> None:
        n = self.decays()
        for g, base in zip(self.sgd.param_groups, self._base):
            g["lr"] = base if n == 0 else float(
                np.float32(base) * _decay_f32(n))


    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.sgd.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def _clip(self) -> None:
        grads = [p.grad for p in self.params if p.grad is not None]
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads]))
        keep = norm < self.clip_gradient
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.clip_gradient))

    def step(self) -> bool:
        """Take this mini-step's gradients; on every ``iter_size``-th call
        clip (trainable groups only), one SGD update of their mean, advance
        the LR. Returns whether the parameters moved."""
        params = self.params
        if self.iter_size > 1:
            grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                     for p in params]
            if self._acc is None:
                self._acc = [torch.zeros_like(p) for p in params]
            n = self.mini_step
            for acc, g in zip(self._acc, grads):
                acc.add_((g - acc) / (n + 1))
            self.mini_step = (n + 1) % self.iter_size
            if self.mini_step:
                return False
            for p, acc in zip(params, self._acc):
                p.grad = acc
            self._acc = None
        if self.clip_gradient is not None:
            self._clip()
        self.sgd.step()
        self.count += 1
        self._set_lr()
        return True


def make_optimizer(model: nn.Module, base_lr: float,
                   lr_steps: Sequence[float], steps_per_epoch: int,
                   momentum: float = 0.9, weight_decay: float = 5e-4,
                   clip_gradient: Optional[float] = None, iter_size: int = 1,
                   start_epoch: int = 0) -> SSNOptimizer:
    """The SSN training optimizer over labeled parameter groups."""
    return SSNOptimizer(model, base_lr, lr_steps, steps_per_epoch, momentum,
                        weight_decay, clip_gradient, iter_size, start_epoch)
