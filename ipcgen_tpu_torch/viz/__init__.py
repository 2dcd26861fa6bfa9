"""Matplotlib visualization suite (port of ``ipcgen_tpu/viz``).

Importing it needs no matplotlib: each draw imports it (``viz/_agg.py``), so
the package imports on the GPU host, where a draw raises ``ImportError``.
"""

from ipcgen_tpu_torch.viz.mesh_viz import MeshVisualizer  # noqa: F401
from ipcgen_tpu_torch.viz.normals_viz import (  # noqa: F401
    visualize_normal_statistics,
    visualize_normals,
    visualize_normals_high_quality,
)
from ipcgen_tpu_torch.viz.scan_viz import ScanResultVisualizer  # noqa: F401
from ipcgen_tpu_torch.viz.scene_viz import (  # noqa: F401
    S3DISVisualizer,
    create_visualization_summary,
)
from ipcgen_tpu_torch.viz.trajectory_viz import TrajectoryVisualizer  # noqa: F401
