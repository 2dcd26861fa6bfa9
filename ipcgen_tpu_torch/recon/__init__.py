"""Surface reconstruction substitute (NKSR-compatible API)."""

from ipcgen_tpu_torch.recon.projection_viz import ReconstructionVisualizer  # noqa: F401
from ipcgen_tpu_torch.recon.reconstructor import (  # noqa: F401
    S3DISEvaluator,
    S3DISReconstructor,
    SemanticMeshReconstructor,
    SurfaceReconstructor,
)
