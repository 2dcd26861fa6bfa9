"""Scene containers: RoomBounds, SemanticInfo, S3DISScene.

API-parity rewrite of the reference containers (containers/s3dis_scene.py:13-211)
over the numpy ``TriMesh`` instead of Open3D geometry.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np

from ipcgen_tpu_torch.containers.mesh import TriMesh


class RoomBounds:
    """Axis-aligned 3D room bounding box (reference: s3dis_scene.py:13-79)."""

    def __init__(self, x_min, x_max, y_min, y_max, z_min, z_max):
        self.x_min = float(x_min)
        self.x_max = float(x_max)
        self.y_min = float(y_min)
        self.y_max = float(y_max)
        self.z_min = float(z_min)
        self.z_max = float(z_max)

    def get_center(self) -> np.ndarray:
        return np.array(
            [
                (self.x_min + self.x_max) / 2,
                (self.y_min + self.y_max) / 2,
                (self.z_min + self.z_max) / 2,
            ]
        )

    def get_size(self) -> np.ndarray:
        return np.array(
            [self.x_max - self.x_min, self.y_max - self.y_min, self.z_max - self.z_min]
        )

    def get_volume(self) -> float:
        size = self.get_size()
        return float(size[0] * size[1] * size[2])

    def is_point_inside(self, point: np.ndarray) -> bool:
        return bool(
            self.x_min <= point[0] <= self.x_max
            and self.y_min <= point[1] <= self.y_max
            and self.z_min <= point[2] <= self.z_max
        )

    def to_dict(self) -> Dict[str, float]:
        return {
            "x_min": self.x_min, "x_max": self.x_max,
            "y_min": self.y_min, "y_max": self.y_max,
            "z_min": self.z_min, "z_max": self.z_max,
        }

    @classmethod
    def from_dict(cls, bounds_dict: Dict[str, float]) -> "RoomBounds":
        return cls(**bounds_dict)

    @classmethod
    def from_mesh(cls, mesh: TriMesh) -> "RoomBounds":
        lo, hi = mesh.bounds()
        return cls(lo[0], hi[0], lo[1], hi[1], lo[2], hi[2])

    @classmethod
    def from_points(cls, points: np.ndarray) -> "RoomBounds":
        lo = points.min(axis=0)
        hi = points.max(axis=0)
        return cls(lo[0], hi[0], lo[1], hi[1], lo[2], hi[2])

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        s = self.get_size()
        return f"RoomBounds(size=[{s[0]:.2f}, {s[1]:.2f}, {s[2]:.2f}])"


class SemanticInfo:
    """Room-level semantic registry (reference: s3dis_scene.py:82-114)."""

    def __init__(
        self,
        room_type: str = "unknown",
        furniture_info: Optional[Dict[str, Any]] = None,
        semantic_labels: Optional[Dict[str, int]] = None,
    ):
        self.room_type = room_type
        self.furniture_info = furniture_info or {}
        self.semantic_labels = semantic_labels or {}

    def add_furniture(
        self, name: str, position: np.ndarray, size: np.ndarray, category: str = "unknown"
    ) -> None:
        self.furniture_info[name] = {
            "position": np.asarray(position).tolist(),
            "size": np.asarray(size).tolist(),
            "category": category,
        }

    def get_furniture_count(self) -> int:
        return len(self.furniture_info)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "room_type": self.room_type,
            "furniture_info": self.furniture_info,
            "semantic_labels": self.semantic_labels,
        }


@dataclass
class S3DISScene:
    """Scene container: name + room mesh + bounds (reference: s3dis_scene.py:117-211)."""

    scene_name: str
    room_mesh: TriMesh
    room_bounds: Optional[RoomBounds] = None
    semantic_info: Optional[SemanticInfo] = None

    def __post_init__(self) -> None:
        if self.room_bounds is None:
            self.room_bounds = RoomBounds.from_mesh(self.room_mesh)
        if self.semantic_info is None:
            self.semantic_info = SemanticInfo()
        self.num_vertices = self.room_mesh.num_vertices
        self.num_triangles = self.room_mesh.num_triangles
        self.mesh_volume = self._calculate_mesh_volume()

    def _calculate_mesh_volume(self) -> float:
        # Bounding-box volume as in the reference (s3dis_scene.py:141-144).
        return self.room_bounds.get_volume()

    def get_bounds_center(self) -> np.ndarray:
        return self.room_bounds.get_center()

    def get_bounds_size(self) -> np.ndarray:
        return self.room_bounds.get_size()

    def is_point_inside(self, point: np.ndarray) -> bool:
        return self.room_bounds.is_point_inside(point)

    def get_mesh_statistics(self) -> Dict[str, Any]:
        return {
            "num_vertices": self.num_vertices,
            "num_triangles": self.num_triangles,
            "volume": self.mesh_volume,
            "bounds": self.room_bounds.to_dict(),
        }

    def save_mesh(self, output_path: Union[str, Path]) -> None:
        self.room_mesh.save(output_path)

    def load_mesh(self, mesh_path: Union[str, Path]) -> bool:
        try:
            mesh = TriMesh.load(mesh_path)
        except Exception:
            return False
        if mesh.is_empty():
            return False
        self.room_mesh = mesh
        self.num_vertices = mesh.num_vertices
        self.num_triangles = mesh.num_triangles
        self.room_bounds = RoomBounds.from_mesh(mesh)
        self.mesh_volume = self._calculate_mesh_volume()
        return True

    def to_dict(self) -> Dict[str, Any]:
        return {
            "scene_name": self.scene_name,
            "room_bounds": self.room_bounds.to_dict(),
            "semantic_info": self.semantic_info.to_dict(),
            "mesh_statistics": self.get_mesh_statistics(),
        }

    @classmethod
    def from_mesh_file(
        cls,
        scene_name: str,
        mesh_path: Union[str, Path],
        semantic_info: Optional[SemanticInfo] = None,
    ) -> "S3DISScene":
        mesh = TriMesh.load(mesh_path)
        if mesh.is_empty():
            raise ValueError(f"Cannot load mesh file: {mesh_path}")
        return cls(scene_name, mesh, semantic_info=semantic_info)

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"S3DISScene(name='{self.scene_name}', vertices={self.num_vertices}, "
            f"triangles={self.num_triangles}, bounds={self.room_bounds.get_size()})"
        )
