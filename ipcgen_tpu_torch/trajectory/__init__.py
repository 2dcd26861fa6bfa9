"""Trajectory planning: waypoints, quality, collision detection, generators.

API parity with reference trajectory/__init__.py:10-19, including the
``SmartTrajectoryGenerator``/``PathType`` pair that the reference imports but
never ships (s3dis_simulator.py:18 — defined here, see SURVEY.md §7).
"""

from ipcgen_tpu_torch.trajectory.auto import AutoTrajectoryGenerator  # noqa: F401
from ipcgen_tpu_torch.trajectory.collision import (  # noqa: F401
    CollisionDetector,
    FurnitureInfo,
)
from ipcgen_tpu_torch.trajectory.smart import PathType, SmartTrajectoryGenerator  # noqa: F401
from ipcgen_tpu_torch.trajectory.waypoint import (  # noqa: F401
    TrajectoryGeneratorBase,
    TrajectoryQuality,
    Waypoint,
)
