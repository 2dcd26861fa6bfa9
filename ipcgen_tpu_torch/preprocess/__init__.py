"""S3DIS loading and preprocessing (outliers, normals, sparsity, occlusion)."""

from ipcgen_tpu_torch.preprocess.loader import (  # noqa: F401
    S3DISLoader,
    S3DISPreprocessor,
    preprocess_room,
)
