"""SSN: structured segment network (torch port of
``action_detection_tpu/models/ssn.py``).

Training: frames ``(P, S, H, W, C)`` -> backbone over P*S -> head dropout
-> STPP (one pooling matmul) -> activity / completeness / regression heads
(:meth:`SSN.forward`). Scoring: the three linear heads fused into one
per-frame test FC (:func:`fuse_test_heads`).

BatchNorm stays frozen (running statistics) in training too: the JAX
package's default ``bn_mode="frozen"``, the only mode of the port.

Module names follow the reference checkpoints: ``base_model`` (the
backbone), ``activity_fc``, ``completeness_fc`` and ``regressor_fc``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.stpp import StppConfig, stpp_train_pool
from .backbones import get_backbone


class SSN(nn.Module):
    """Three-head SSN classifier over STPP-pooled segment features."""

    def __init__(self, num_class: int, modality: str = "RGB",
                 base_model: str = "BNInception",
                 new_length: Optional[int] = None, dropout: float = 0.8,
                 with_regression: bool = True,
                 stpp_cfg: Tuple = (1, 1, 1),
                 standalone_classifier: bool = True,
                 starting_segment: int = 2, course_segment: int = 5,
                 ending_segment: int = 2):
        super().__init__()
        self.num_class = num_class
        self.modality = modality
        self.arch = base_model
        self.new_length = new_length
        self.dropout = dropout
        self.with_regression = with_regression
        self.stpp = StppConfig.from_raw(stpp_cfg)
        self.standalone_classifier = standalone_classifier
        self.seg_split = (starting_segment, starting_segment + course_segment,
                          starting_segment + course_segment + ending_segment)

        self.base_model, self.feature_dim, self.input_spec = get_backbone(
            base_model, modality, new_length)
        J = self.stpp.feat_multiplier
        act_in = self.feature_dim if standalone_classifier \
            else J * self.feature_dim
        self.activity_fc = nn.Linear(act_in, num_class + 1)
        self.completeness_fc = nn.Linear(J * self.feature_dim, num_class)
        if with_regression:
            self.regressor_fc = nn.Linear(J * self.feature_dim, 2 * num_class)

    @property
    def resolved_new_length(self) -> int:
        if self.new_length is None:
            return 1 if self.modality == "RGB" else 5
        return self.new_length

    def train(self, mode: bool = True) -> "SSN":
        """Train mode everywhere but the BatchNorm layers (frozen BN)."""
        super().train(mode)
        for m in self.base_model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.eval()
        return self

    def features(self, frames: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, H, W, C) normalized frames -> (N, D) features, with the head
        dropout in train mode (mask drawn from ``generator``)."""
        feats = self.base_model(frames)
        if self.training and self.dropout > 0:
            keep = torch.rand(feats.shape, generator=generator,
                              device=feats.device) >= self.dropout
            feats = feats * keep / (1.0 - self.dropout)
        return feats

    def forward(self, frames: torch.Tensor, scaling: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        """Training/validation forward over proposals.

        ``frames`` (P, S, H, W, C) normalized segment frames, ``scaling``
        (P, 2) start/end stage validity scalings. Returns activity logits
        (P, K+1), completeness (P, K) and regression (P, K, 2) or None.
        """
        P, S = frames.shape[:2]
        feats = self.features(frames.reshape((P * S,) + frames.shape[2:]),
                              generator).reshape(P, S, self.feature_dim)
        act_ft, comp_ft = stpp_train_pool(
            feats, scaling, self.seg_split, self.stpp,
            standalone_classifier=self.standalone_classifier)
        act = self.activity_fc(act_ft)
        comp = self.completeness_fc(comp_ft)
        reg = None
        if self.with_regression:
            reg = self.regressor_fc(comp_ft).reshape(P, self.num_class, 2)
        return act, comp, reg


def fuse_test_heads(model: SSN, num_class: int, stpp_cfg=(1, 1, 1),
                    with_regression: bool = True,
                    standalone_classifier: bool = True):
    """Reorganize the three linear heads into one fused per-frame test FC.

    Because the heads are linear, ``head(pool(features)) ==
    pool(head(features))``. Column layout: ``[activity | completeness
    part-major | regression part-major]``; each part block carries
    ``bias / feat_multiplier`` so the pooled sum reproduces the bias once.

    Returns ``(kernel (D, total_cols), bias (total_cols,))`` float32 tensors
    on the model's device.
    """
    cfg = StppConfig.from_raw(stpp_cfg)
    J = cfg.feat_multiplier
    with torch.no_grad():
        act_k = model.activity_fc.weight.t()          # (D or J*D, K+1)
        act_b = model.activity_fc.bias
        comp_k = model.completeness_fc.weight.t()     # (J*D, K)
        comp_b = model.completeness_fc.bias

        feat_dim = comp_k.shape[0] // J
        K = num_class
        if not standalone_classifier:
            act_parts = act_k.reshape(J, feat_dim, K + 1)
            act_cols = [torch.cat([act_parts[j] for j in range(J)], dim=1)]
            biases = [torch.broadcast_to(act_b / J, (J, K + 1)).reshape(-1)]
        else:
            act_cols = [act_k]
            biases = [act_b]

        comp_parts = comp_k.reshape(J, feat_dim, K)
        cols = act_cols + [comp_parts[j] for j in range(J)]
        biases.append((comp_b / J).repeat(J))
        if with_regression:
            reg_k = model.regressor_fc.weight.t()     # (J*D, 2K)
            reg_b = model.regressor_fc.bias
            reg_parts = reg_k.reshape(J, feat_dim, 2 * K)
            cols.extend(reg_parts[j] for j in range(J))
            biases.append((reg_b / J).repeat(J))
        return (torch.cat(cols, dim=1).contiguous().float(),
                torch.cat(biases).float())
