"""Sensor models: LiDAR intrinsics profiles, beam patterns and the sensor
classes, in torch."""

from ipcgen_tpu_torch.models.lidar import (  # noqa: F401
    DualAxisLidar,
    IndoorLidar,
    create_lidar,
    get_lidar_type,
)
from ipcgen_tpu_torch.models.lidar_intrinsics import (  # noqa: F401
    DualAxisLidarIntrinsics,
    Indoor8LineLidarIntrinsics,
    LidarIntrinsics,
    from_reference,
)
