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
parameters out. Gradient accumulation (``--iter_size``) and resuming at an
epoch come with the training CLI.
``torch.optim.SGD`` (momentum, no dampening, weight decay added to the
gradient) is the same update as the JAX package's optax chain:
``u = g + wd*p; m = u + momentum*m; p -= lr*m``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

# the first convolution of each supported backbone (cross-modality
# finetuning gives it its own lr/decay multipliers)
FIRST_CONV_NAMES = ("conv1_7x7_s2", "Conv2d_1a_3x3_conv", "conv1",
                    "features_0")

_MULTS = {"first_conv_weight": (1.0, 1.0), "first_conv_bias": (2.0, 0.0),
          "normal_weight": (1.0, 1.0), "normal_bias": (2.0, 0.0)}


def label_param(name: str, module: nn.Module) -> str:
    """The optimization group of one parameter, from its module."""
    path = name.split(".")
    layer, leaf = path[:-1], path[-1]
    if isinstance(module, nn.modules.batchnorm._BatchNorm):
        return "bn_frozen"
    # the first conv only at the backbone's top level
    first = (len(layer) >= 1 and layer[-1] in FIRST_CONV_NAMES
             and (len(layer) == 1 or layer[-2] == "base_model"))
    if leaf == "bias":
        return "first_conv_bias" if first else "normal_bias"
    return "first_conv_weight" if first else "normal_weight"


def label_params(model: nn.Module) -> Dict[str, str]:
    """``{parameter name: group}`` over the whole model."""
    modules = dict(model.named_modules())
    return {name: label_param(name, modules[name.rpartition(".")[0]])
            for name, _ in model.named_parameters()}


class SSNOptimizer:
    """SGD over the trainable groups + step-decay LR + optional clip."""

    def __init__(self, model: nn.Module, base_lr: float,
                 lr_steps: Sequence[float], steps_per_epoch: int,
                 momentum: float = 0.9, weight_decay: float = 5e-4,
                 clip_gradient: Optional[float] = None):
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
        self.boundaries = (np.asarray(sorted(lr_steps), np.float64)
                           * steps_per_epoch)
        self.count = 0
        self.clip_gradient = clip_gradient
        self._base = [g["lr"] for g in self.sgd.param_groups]
        self._set_lr()

    def lr_factor(self) -> float:
        return 0.1 ** int(np.sum(self.count >= self.boundaries))

    def _set_lr(self) -> None:
        f = self.lr_factor()
        for g, base in zip(self.sgd.param_groups, self._base):
            g["lr"] = base * f

    @property
    def params(self) -> List[torch.Tensor]:
        return [p for g in self.sgd.param_groups for p in g["params"]]

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self) -> None:
        """Clip (trainable groups only), one SGD update, advance the LR."""
        if self.clip_gradient is not None:
            nn.utils.clip_grad_norm_(self.params, self.clip_gradient)
        self.sgd.step()
        self.count += 1
        self._set_lr()


def make_optimizer(model: nn.Module, base_lr: float,
                   lr_steps: Sequence[float], steps_per_epoch: int,
                   momentum: float = 0.9, weight_decay: float = 5e-4,
                   clip_gradient: Optional[float] = None) -> SSNOptimizer:
    """The SSN training optimizer over labeled parameter groups."""
    return SSNOptimizer(model, base_lr, lr_steps, steps_per_epoch, momentum,
                        weight_decay, clip_gradient)
