"""Semantic label machinery: annotation loading, color codecs, label transfer."""

from ipcgen_tpu_torch.semantic.annotations import (  # noqa: F401
    S3DISAnnotationLoader,
    S3DISColorEncoder,
    get_semantic_colors_from_points,
    get_semantic_colors_with_instances_from_points,
    load_s3dis_room_labels,
)
from ipcgen_tpu_torch.semantic.color_encoder import (  # noqa: F401
    SemanticColorEncoder,
    create_s3dis_color_encoder,
)
