"""What the float backbones share for training: BatchNorm with the JAX
package's ``bn_mode`` semantics, per-stage activation checkpointing
(``--remat``) and dropout from an explicit generator.

The JAX package trains BatchNorm three ways (``bn_mode``): ``frozen`` (every
BN normalizes with its running statistics, the default), ``partial`` (only
the first BN of the backbone uses batch statistics) and ``full`` (every BN
does). Its affine parameters are never trained in any mode: the optimizer
leaves them out (``train/optim.py``).

Inside a process group of several ranks (data-parallel training,
``parallel/mesh.py``) both stay the global batch's, as in the JAX
package's jitted step over a sharded batch: batch statistics are
all-reduced across the ranks, and dropout masks are cut from one mask over
the global batch.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...parallel.mesh import distributed

BN_MODES = ("frozen", "partial", "full")


def at_least_f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32, or as it is in float64 (the parity tests' dtype)."""
    return x if x.dtype == torch.float64 else x.float()


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` with flax's training semantics.

    Unless ``use_batch_stats`` is set and the module is in train mode, it
    normalizes with its running statistics (frozen). Otherwise it normalizes
    with the batch's statistics as flax's ``BatchNorm`` computes them: in
    float32, the mean and the biased variance ``max(E[x^2] - E[x]^2, 0)``,
    gradients through both; and it keeps them in ``pending`` until
    :func:`commit_batch_stats` folds them into the running statistics.
    (``nn.BatchNorm2d`` in train mode would update ``running_var`` with the
    unbiased variance.) The output has the input's dtype; a float64 input
    is normalized in float64.

    Under a process group of several ranks the statistics are the global
    batch's: the sums of x and x^2 and the count are all-reduced with a
    differentiable all-reduce (its backward sums the ranks' gradients), so
    every rank normalizes alike and gradients flow through the global mean
    (``SyncBatchNorm`` would take the unbiased variance into the running
    statistics too).
    """

    use_batch_stats = False

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__(num_features, eps=eps)
        self.pending: Optional[Tuple[torch.Tensor, torch.Tensor]] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not (self.training and self.use_batch_stats):
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        xf = at_least_f32(x)
        if distributed():
            from torch.distributed.nn.functional import all_reduce

            count = torch.full_like(xf[0, :, 0, 0], xf.numel() / xf.shape[1])
            sums = all_reduce(torch.stack([xf.sum((0, 2, 3)),
                                           (xf * xf).sum((0, 2, 3)), count]))
            mean, ex2 = sums[0] / sums[2], sums[1] / sums[2]
        else:
            mean, ex2 = xf.mean((0, 2, 3)), (xf * xf).mean((0, 2, 3))
        var = torch.clamp(ex2 - mean * mean, min=0.0)
        self.pending = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def set_bn_mode(backbone: nn.Module, mode: str, partial: int = 1) -> None:
    """Mark the backbone's BatchNorms for ``mode``: ``partial`` trains the
    first ``partial`` of them in registration order (the backbone's first
    BN; TinyConv passes 0, as the JAX TinyConv trains BN only in ``full``)."""
    if mode not in BN_MODES:
        raise ValueError(f"unknown bn mode {mode!r} (one of {BN_MODES})")
    bns = [m for m in backbone.modules() if isinstance(m, BatchNorm2d)]
    for i, m in enumerate(bns):
        m.use_batch_stats = mode == "full" or (mode == "partial"
                                               and i < partial)


def commit_batch_stats(model: nn.Module, momentum: float = 0.9) -> None:
    """Fold every BN's pending batch statistics into its running ones, as
    flax does after a train step: ``r = momentum * r + (1 - momentum) *
    batch``."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm2d) and m.pending is not None:
                mean, var = m.pending
                m.running_mean.copy_(momentum * m.running_mean
                                     + (1 - momentum) * mean)
                m.running_var.copy_(momentum * m.running_var
                                    + (1 - momentum) * var)
                m.pending = None


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Inverted dropout with its keep mask drawn from ``generator`` (the
    train step's explicit generator, on ``x``'s device); the caller applies
    it in train mode only. Under a process group of several ranks, whose
    generators share one seed, the mask is drawn over the global batch
    (``world`` times ``x``'s rows) and this rank keeps its rows, so a step
    of several ranks draws what one rank would on the whole batch."""
    if rate <= 0:
        return x
    shape, rows = tuple(x.shape), slice(None)
    if distributed():
        import torch.distributed as dist

        n = shape[0]
        shape = (n * dist.get_world_size(),) + shape[1:]
        rows = slice(dist.get_rank() * n, (dist.get_rank() + 1) * n)
    keep = torch.rand(shape, generator=generator,
                      device=x.device)[rows] >= rate
    return x * keep / (1.0 - rate)


def run_stage(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
              remat: bool) -> torch.Tensor:
    """``fn(x)``; with ``remat`` under autograd, through non-reentrant
    ``torch.utils.checkpoint``: the stage keeps only its input for the
    backward pass and runs again there."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)
