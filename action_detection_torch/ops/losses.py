"""SSN losses: activity CE, OHEM hinge completeness, class-wise regression.

Port of ``action_detection_tpu/ops/losses.py``. OHEM keeps each group's
hardest hinge losses with ``torch.topk``; gradients flow only through the
kept, margin-violating samples. Among exactly equal losses the kept index
may differ from ``lax.top_k``'s, which changes neither the loss nor, for
equal zero losses, the gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def ohem_hinge_loss(pred: torch.Tensor, labels: torch.Tensor,
                    is_positive: int, ohem_ratio: float,
                    group_size: int) -> torch.Tensor:
    """Sum of each group's kept GT-class hinge losses ``max(1 - y*s, 0)``.

    ``pred`` (N, K) raw completeness scores with N a multiple of
    ``group_size``; ``labels`` (N,) in ``1..K``; ``is_positive`` +1 or -1.
    """
    n = pred.shape[0]
    cls_score = pred.gather(1, (labels - 1)[:, None])[:, 0]
    margin = 1.0 - is_positive * cls_score
    losses = torch.where(margin > 0, margin, torch.zeros_like(margin))
    losses = losses.reshape(n // group_size, group_size)
    keep_num = int(group_size * ohem_ratio)
    return torch.topk(losses, keep_num, dim=1).values.sum()


def completeness_loss(pred: torch.Tensor, labels: torch.Tensor,
                      sample_split: int, sample_group_size: int,
                      ohem_ratio: float = 0.17) -> torch.Tensor:
    """OHEM completeness loss over per-video groups of ``sample_group_size``
    proposals, ``sample_split`` complete positives first: every positive
    counts, only the hardest ``ohem_ratio`` of the negatives do; normalized
    by the number of contributing samples."""
    pred_dim = pred.shape[1]
    pred_g = pred.reshape(-1, sample_group_size, pred_dim)
    labels_g = labels.reshape(-1, sample_group_size)
    pos_pred = pred_g[:, :sample_split].reshape(-1, pred_dim)
    neg_pred = pred_g[:, sample_split:].reshape(-1, pred_dim)
    pos_ls = ohem_hinge_loss(pos_pred, labels_g[:, :sample_split].reshape(-1),
                             1, 1.0, sample_split)
    neg_ls = ohem_hinge_loss(neg_pred, labels_g[:, sample_split:].reshape(-1),
                             -1, ohem_ratio, sample_group_size - sample_split)
    pos_cnt = pos_pred.shape[0]
    neg_cnt = int(neg_pred.shape[0] * ohem_ratio)
    return (pos_ls + neg_ls) / float(pos_cnt + neg_cnt)


def classwise_regression_loss(pred: torch.Tensor, labels: torch.Tensor,
                              targets: torch.Tensor) -> torch.Tensor:
    """Smooth-L1 on the GT-class (center shift, log duration) pair, doubled.

    ``pred`` (N, K, 2), ``labels`` (N,) in ``1..K``, ``targets`` (N, 2).
    """
    idx = (labels - 1)[:, None, None].expand(pred.shape[0], 1, 2)
    diff = pred.gather(1, idx)[:, 0, :] - targets
    adiff = diff.abs()
    elem = torch.where(adiff < 1.0, 0.5 * diff * diff, adiff - 0.5)
    return elem.mean() * 2.0


def activity_cross_entropy(logits: torch.Tensor,
                           labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy with integer labels (activity head)."""
    return F.cross_entropy(logits, labels)


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Top-1 accuracy in percent (training diagnostics)."""
    return (logits.argmax(dim=-1) == labels).float().mean() * 100.0
