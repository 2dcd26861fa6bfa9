"""I/O codecs: PLY (points, meshes, labeled 8-attribute), S3DIS txt parsers."""

from ipcgen_tpu_torch.io.ply import (  # noqa: F401
    read_labeled_ply,
    read_ply,
    read_point_cloud,
    read_triangle_mesh,
    write_labeled_ply,
    write_point_cloud,
    write_triangle_mesh,
)
