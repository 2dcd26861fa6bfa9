"""3D detection box generation (Group-Free-3D / VoteNet compatible)."""

from ipcgen_tpu_torch.bbox.detection import (  # noqa: F401
    CLASS_NAME_MAPPING,
    DETECTION_CLASSES,
    LIDAR_NET_SEMANTIC_MAPPING,
    LiDARNetBBoxVisualizer,
    S3DISBBoxVisualizer,
    calculate_bbox,
    generate_detection_annotations,
)
