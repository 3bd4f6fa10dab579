from .iou import (
    temporal_iou,
    temporal_iou_matrix,
    overlap_over_b,
    temporal_recall,
    name_proposal,
    get_temporal_proposal_recall,
)
from .stpp import (
    parse_stage_config,
    StppConfig,
    ReorganizedScoreLayout,
    reference_part_bounds,
    reorganized_score_slices,
    reorganized_stpp_pool,
)
