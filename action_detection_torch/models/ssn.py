"""SSN: structured segment network (torch port of
``action_detection_tpu/models/ssn.py``).

Training: frames ``(P, S, H, W, C)`` -> backbone over P*S -> head dropout
-> STPP (one pooling matmul) -> activity / completeness / regression heads
(:meth:`SSN.forward`). Scoring: the three linear heads fused into one
per-frame test FC (:func:`fuse_test_heads`).

BatchNorm stays frozen (running statistics) in training unless
``bn_mode`` says otherwise (``partial``: the backbone's first BN uses batch
statistics; ``full``: every BN does; ``models/backbones/common.py``).
``dtype=torch.bfloat16`` (``--bf16``) runs the backbone in bf16 with float32
parameters; ``remat`` checkpoints the backbone stage by stage.

Module names follow the reference checkpoints: ``base_model`` (the
backbone), ``activity_fc``, ``completeness_fc`` and ``regressor_fc``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops.stpp import StppConfig, stpp_train_pool
from .backbones import get_backbone
from .backbones.common import BatchNorm2d, at_least_f32, dropout
from .backbones.vgg import VGG


class FrozenBNClassifier(nn.Module):
    """A backbone (``base_model``) under linear heads, the frame of
    :class:`SSN` and :class:`~.binary.BinaryClassifier`: BatchNorm as
    ``bn_mode`` says (frozen by default, in train mode too), the backbone in
    ``dtype``, and the head dropout applied to the features."""

    def __init__(self, base_model: str, modality: str,
                 new_length: Optional[int], dropout: float,
                 bn_mode: str = "frozen", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16, torch.float64):
            # float64 holds parity tests to rounding (TinyConv, no max pool)
            raise ValueError(f"dtype {dtype}: float32, bfloat16 or float64")
        self.arch = base_model
        self.modality = modality
        self.new_length = new_length
        self.dropout = dropout
        self.dtype = dtype
        self.base_model, self.feature_dim, self.input_spec = get_backbone(
            base_model, modality, new_length, bn_mode=bn_mode, remat=remat)

    @property
    def resolved_new_length(self) -> int:
        if self.new_length is None:
            return 1 if self.modality == "RGB" else 5
        return self.new_length

    def train(self, mode: bool = True) -> "FrozenBNClassifier":
        """Train mode everywhere but the frozen BatchNorm layers."""
        super().train(mode)
        for m in self.base_model.modules():
            if isinstance(m, BatchNorm2d) and not m.use_batch_stats:
                m.eval()
        return self

    def features(self, frames: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(N, H, W, C) normalized frames -> (N, D) float32 (float64 in a
        float64 model) features, with
        the head dropout in train mode (mask drawn from ``generator``, as
        VGG's classifier dropouts are).
        In bf16 the frames are rounded to bf16 first and the backbone runs
        under autocast, as the JAX backbones cast their input to ``dtype``."""
        bf16 = self.dtype == torch.bfloat16
        # VGG's classifier dropouts draw from the same generator
        kw = ({"generator": generator} if isinstance(self.base_model, VGG)
              else {})
        with torch.autocast(frames.device.type, dtype=torch.bfloat16,
                            enabled=bf16):
            feats = at_least_f32(self.base_model(frames.to(self.dtype),
                                                 **kw))
        if self.training:
            feats = dropout(feats, self.dropout, generator)
        return feats


class SSN(FrozenBNClassifier):
    """Three-head SSN classifier over STPP-pooled segment features."""

    def __init__(self, num_class: int, modality: str = "RGB",
                 base_model: str = "BNInception",
                 new_length: Optional[int] = None, dropout: float = 0.8,
                 with_regression: bool = True,
                 stpp_cfg: Tuple = (1, 1, 1),
                 standalone_classifier: bool = True,
                 starting_segment: int = 2, course_segment: int = 5,
                 ending_segment: int = 2, bn_mode: str = "frozen",
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__(base_model, modality, new_length, dropout, bn_mode,
                         dtype, remat)
        self.num_class = num_class
        self.with_regression = with_regression
        self.stpp = StppConfig.from_raw(stpp_cfg)
        self.standalone_classifier = standalone_classifier
        self.seg_split = (starting_segment, starting_segment + course_segment,
                          starting_segment + course_segment + ending_segment)

        J = self.stpp.feat_multiplier
        act_in = self.feature_dim if standalone_classifier \
            else J * self.feature_dim
        self.activity_fc = nn.Linear(act_in, num_class + 1)
        self.completeness_fc = nn.Linear(J * self.feature_dim, num_class)
        if with_regression:
            self.regressor_fc = nn.Linear(J * self.feature_dim, 2 * num_class)

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
