"""Collision detection for trajectory planning.

API-parity rewrite of reference trajectory/collision_detector.py:13-259 with
its bug fixed rather than copied: ``FurnitureInfo.mesh`` was referenced but
never declared there (:126, :151) — it is a real optional field here.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ipcgen_tpu_torch.trajectory.waypoint import Waypoint


@dataclass
class FurnitureInfo:
    """AABB furniture proxy for planning (reference: :13-41)."""

    name: str
    position: np.ndarray  # (3,)
    size: np.ndarray  # (3,)
    category: str
    mesh: Optional[object] = None  # optional TriMesh for precise checks

    def get_bounds(self) -> Dict[str, float]:
        half = np.asarray(self.size) / 2
        pos = np.asarray(self.position)
        return {
            "x_min": pos[0] - half[0], "x_max": pos[0] + half[0],
            "y_min": pos[1] - half[1], "y_max": pos[1] + half[1],
            "z_min": pos[2] - half[2], "z_max": pos[2] + half[2],
        }

    def is_point_inside(self, point: np.ndarray) -> bool:
        b = self.get_bounds()
        return bool(
            b["x_min"] <= point[0] <= b["x_max"]
            and b["y_min"] <= point[1] <= b["y_max"]
            and b["z_min"] <= point[2] <= b["z_max"]
        )


class CollisionDetector:
    """Robot-vs-furniture AABB collision checks (reference: :44-259)."""

    def __init__(self, robot_radius: float = 0.3):
        self.robot_radius = robot_radius
        self.furniture_list: List[FurnitureInfo] = []

    def add_furniture(self, furniture: FurnitureInfo) -> None:
        self.furniture_list.append(furniture)

    def add_furniture_from_mesh(self, mesh, name: str, category: str = "unknown") -> None:
        vertices = np.asarray(mesh.vertices)
        if len(vertices) == 0:
            return
        position = np.mean(vertices, axis=0)
        size = np.max(vertices, axis=0) - np.min(vertices, axis=0)
        self.add_furniture(
            FurnitureInfo(name=name, position=position, size=size, category=category, mesh=mesh)
        )

    def detect_collision(self, waypoint: Waypoint) -> Tuple[bool, Optional[FurnitureInfo]]:
        robot_pos = np.array([waypoint.x, waypoint.y, waypoint.z])
        for furniture in self.furniture_list:
            if self._check_robot_furniture_collision(robot_pos, furniture):
                return True, furniture
        return False, None

    def detect_path_collision(
        self, waypoints: List[Waypoint]
    ) -> List[Tuple[int, FurnitureInfo]]:
        collisions = []
        for i, waypoint in enumerate(waypoints):
            has_collision, furniture = self.detect_collision(waypoint)
            if has_collision:
                collisions.append((i, furniture))
        return collisions

    def _check_robot_furniture_collision(
        self, robot_pos: np.ndarray, furniture: FurnitureInfo
    ) -> bool:
        if self._check_bbox_collision(robot_pos, furniture):
            return True
        if furniture.mesh is not None:
            return self._check_mesh_collision(robot_pos, furniture)
        return False

    def _check_bbox_collision(self, robot_pos: np.ndarray, furniture: FurnitureInfo) -> bool:
        b = furniture.get_bounds()
        r = self.robot_radius
        return bool(
            b["x_min"] - r <= robot_pos[0] <= b["x_max"] + r
            and b["y_min"] - r <= robot_pos[1] <= b["y_max"] + r
            and b["z_min"] - r <= robot_pos[2] <= b["z_max"] + r
        )

    def _check_mesh_collision(self, robot_pos: np.ndarray, furniture: FurnitureInfo) -> bool:
        if furniture.mesh is None:
            return False
        vertices = np.asarray(furniture.mesh.vertices)
        if len(vertices) == 0:
            return False
        # Any mesh vertex within the robot sphere counts as a collision
        # (tighter than the reference's bbox-only check, same intent).
        d = np.linalg.norm(vertices - robot_pos, axis=1)
        return bool(np.any(d <= self.robot_radius)) or furniture.is_point_inside(robot_pos)

    def suggest_avoidance_path(
        self, waypoint: Waypoint, collided_furniture: FurnitureInfo
    ) -> List[Waypoint]:
        """Left/right bypass + backward fallback (reference: :169-223)."""
        avoidance_waypoints = []
        furniture_center = np.asarray(collided_furniture.position)
        robot_pos = np.array([waypoint.x, waypoint.y, waypoint.z])
        direction = furniture_center - robot_pos
        direction[2] = 0
        norm = np.linalg.norm(direction)
        if norm > 0:
            direction = direction / norm
        avoidance_distance = self.robot_radius + 0.5
        for angle_offset in [-np.pi / 2, np.pi / 2]:
            avoid_dir = self._rotate_vector(direction, angle_offset)
            pos = robot_pos + avoid_dir * avoidance_distance
            avoidance_waypoints.append(
                Waypoint(x=pos[0], y=pos[1], z=pos[2], yaw=waypoint.yaw + angle_offset)
            )
        back_pos = robot_pos - direction * avoidance_distance
        avoidance_waypoints.append(
            Waypoint(x=back_pos[0], y=back_pos[1], z=back_pos[2], yaw=waypoint.yaw)
        )
        return avoidance_waypoints

    @staticmethod
    def _rotate_vector(vector: np.ndarray, angle: float) -> np.ndarray:
        c, s = np.cos(angle), np.sin(angle)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
        return rot @ vector

    def get_furniture_list(self) -> List[FurnitureInfo]:
        return self.furniture_list.copy()

    def clear_furniture(self) -> None:
        self.furniture_list.clear()

    def get_collision_statistics(self, waypoints: List[Waypoint]) -> Dict[str, Any]:
        collisions = self.detect_path_collision(waypoints)
        collision_furniture: Dict[str, int] = {}
        for _, furniture in collisions:
            collision_furniture[furniture.name] = (
                collision_furniture.get(furniture.name, 0) + 1
            )
        return {
            "total_collisions": len(collisions),
            "collision_rate": len(collisions) / len(waypoints) if waypoints else 0,
            "collision_furniture": collision_furniture,
        }
