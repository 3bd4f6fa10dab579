"""Binary actionness classifier used by TAG proposal generation (torch port
of ``action_detection_tpu/models/binary.py``).

A TSN-style classifier that averages the features of the course segments of
a proposal and applies one linear head. At test time the head applies per
frame (:meth:`BinaryClassifier.score_frames`): dense per-frame actionness
logits. Module names follow the reference checkpoints: ``base_model`` (the
backbone) and ``classifier_fc``. ``bn_mode`` and ``dtype`` train as in
:class:`~.ssn.FrozenBNClassifier`.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .ssn import FrozenBNClassifier


class BinaryClassifier(FrozenBNClassifier):
    """Course-segment-mean TSN binary classifier."""

    def __init__(self, num_class: int = 2, course_segment: int = 5,
                 modality: str = "RGB", base_model: str = "BNInception",
                 new_length: Optional[int] = None, dropout: float = 0.8,
                 bn_mode: str = "frozen", dtype: torch.dtype = torch.float32):
        super().__init__(base_model, modality, new_length, dropout, bn_mode,
                         dtype)
        self.num_class = num_class
        self.course_segment = course_segment
        self.classifier_fc = nn.Linear(self.feature_dim, num_class)

    def forward(self, frames: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Training forward: ``(P, S, H, W, C)`` -> ``(P, num_class)`` logits
        of the course-segment mean feature."""
        P, S = frames.shape[:2]
        feats = self.features(frames.reshape((P * S,) + frames.shape[2:]),
                              generator).reshape(P, S, self.feature_dim)
        return self.classifier_fc(feats.mean(dim=1))

    def score_frames(self, frames: torch.Tensor) -> torch.Tensor:
        """Dense inference: per-frame actionness logits ``(N, num_class)``.
        The head is linear, so per-frame scores need no reorganization."""
        return self.classifier_fc(self.features(frames))
