from .detection import (
    merge_score_dicts,
    generate_detections,
    apply_classwise_nms,
    apply_regression,
    perform_regression,
    evaluate_detections,
    format_map_table,
)
