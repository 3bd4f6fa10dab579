# Host-only re-exports: the host CLIs import this package without torch.
# The device ops (stpp, pooling, losses) are imported by module.
from .iou import (
    temporal_iou,
    temporal_iou_matrix,
    overlap_over_b,
    temporal_recall,
    name_proposal,
    get_temporal_proposal_recall,
)
from .nms import temporal_nms, temporal_nms_indices
