"""Multi-device parallelism: device meshes and sharded scan paths over
``torch.distributed`` (port of ``ipcgen_tpu/parallel``)."""

from ipcgen_tpu_torch.parallel.shard import (  # noqa: F401
    make_device_mesh,
    scan_waypoints_sharded,
    sharded_raycast_rays,
    sharded_raycast_tris,
)
