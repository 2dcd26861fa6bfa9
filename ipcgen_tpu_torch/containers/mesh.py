"""Triangle mesh container (replaces ``o3d.geometry.TriangleMesh``).

The reference passes Open3D meshes between every stage (e.g. scene loading
at s3dis_simulator.py:91, export at s3dis_nksr_reconstructor.py:145); this
is the plain-numpy host-side equivalent, with area/normal/volume helpers
standing in for Open3D's C++ accessors. The device-resident acceleration
structure lives in ``ipcgen_tpu_torch.ops.scene_asset``.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Union

import numpy as np

from ipcgen_tpu_torch.io import ply as plyio


@dataclass
class TriMesh:
    """Host-side triangle mesh: vertices (V,3), triangles (T,3) int32."""

    vertices: np.ndarray
    triangles: np.ndarray
    vertex_colors: Optional[np.ndarray] = None  # (V, 3) float in [0, 1]
    vertex_normals: Optional[np.ndarray] = None  # (V, 3)

    def __post_init__(self) -> None:
        self.vertices = np.asarray(self.vertices, dtype=np.float64).reshape(-1, 3)
        self.triangles = np.asarray(self.triangles, dtype=np.int32).reshape(-1, 3)

    # ------------------------------------------------------------------
    @property
    def num_vertices(self) -> int:
        return len(self.vertices)

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    def is_empty(self) -> bool:
        return self.num_vertices == 0

    def bounds(self) -> np.ndarray:
        """(2, 3) min/max corner of the vertex AABB."""
        if self.is_empty():
            return np.zeros((2, 3))
        return np.stack([self.vertices.min(axis=0), self.vertices.max(axis=0)])

    def triangle_corners(self) -> np.ndarray:
        """(T, 3, 3) triangle corner positions."""
        return self.vertices[self.triangles]

    def triangle_areas(self) -> np.ndarray:
        c = self.triangle_corners()
        return 0.5 * np.linalg.norm(
            np.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0]), axis=1
        )

    def surface_area(self) -> float:
        return float(self.triangle_areas().sum())

    def face_normals(self, normalized: bool = True) -> np.ndarray:
        c = self.triangle_corners()
        n = np.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0])
        if normalized:
            n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
        return n

    def compute_vertex_normals(self) -> np.ndarray:
        """Area-weighted vertex normals (stored on the mesh and returned)."""
        fn = self.face_normals(normalized=False)  # area-weighted
        vn = np.zeros_like(self.vertices)
        for k in range(3):
            np.add.at(vn, self.triangles[:, k], fn)
        vn /= np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
        self.vertex_normals = vn
        return vn

    def signed_volume(self) -> float:
        """Signed volume via the divergence theorem (exact for watertight meshes)."""
        c = self.triangle_corners()
        return float(np.einsum("ij,ij->i", c[:, 0], np.cross(c[:, 1], c[:, 2])).sum() / 6.0)

    # ------------------------------------------------------------------
    def save(self, path: Union[str, Path]) -> None:
        plyio.write_triangle_mesh(
            path, self.vertices, self.triangles, self.vertex_colors, self.vertex_normals
        )

    @classmethod
    def load(cls, path: Union[str, Path]) -> "TriMesh":
        vertices, triangles, colors = plyio.read_triangle_mesh(path)
        return cls(vertices=vertices, triangles=triangles, vertex_colors=colors)

    # ------------------------------------------------------------------
    @classmethod
    def box(
        cls,
        center=(0.0, 0.0, 0.0),
        size=(1.0, 1.0, 1.0),
        inward: bool = False,
    ) -> "TriMesh":
        """Axis-aligned box mesh (12 triangles).

        ``inward=True`` flips winding so normals face the interior — useful
        as a synthetic 'room' whose walls a LiDAR placed inside can hit.
        """
        center = np.asarray(center, dtype=np.float64)
        half = np.asarray(size, dtype=np.float64) / 2.0
        corners = np.array(
            [
                [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
            ],
            dtype=np.float64,
        )
        vertices = center + corners * half
        faces = np.array(
            [
                [0, 2, 1], [0, 3, 2],  # bottom (z-)
                [4, 5, 6], [4, 6, 7],  # top (z+)
                [0, 1, 5], [0, 5, 4],  # y-
                [2, 3, 7], [2, 7, 6],  # y+
                [0, 4, 7], [0, 7, 3],  # x-
                [1, 2, 6], [1, 6, 5],  # x+
            ],
            dtype=np.int32,
        )
        if inward:
            faces = faces[:, [0, 2, 1]]
        return cls(vertices=vertices, triangles=faces)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"TriMesh(V={self.num_vertices}, T={self.num_triangles})"
