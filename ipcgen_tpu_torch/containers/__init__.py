"""Host-side data containers (copy of ``ipcgen_tpu/containers``; API parity
with reference containers/__init__.py:11-23)."""

from ipcgen_tpu_torch.containers.frame import LidarPose, RobotPose, S3DISFrame  # noqa: F401
from ipcgen_tpu_torch.containers.mesh import TriMesh  # noqa: F401
from ipcgen_tpu_torch.containers.scene import RoomBounds, S3DISScene, SemanticInfo  # noqa: F401
from ipcgen_tpu_torch.containers.sim_frame import (  # noqa: F401
    IncidentAngles,
    S3DISSimFrame,
    ScanQuality,
)
from ipcgen_tpu_torch.containers.sim_scene import (  # noqa: F401
    ResultExporter,
    S3DISSimScene,
    SimulationStats,
)

__all__ = [
    "TriMesh",
    "RoomBounds",
    "SemanticInfo",
    "S3DISScene",
    "RobotPose",
    "LidarPose",
    "S3DISFrame",
    "ScanQuality",
    "IncidentAngles",
    "S3DISSimFrame",
    "SimulationStats",
    "ResultExporter",
    "S3DISSimScene",
]
