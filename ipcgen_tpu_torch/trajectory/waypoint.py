"""Waypoint, trajectory quality, and generator base.

API-parity rewrite of reference trajectory/trajectory_generator.py:12-223.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclass
class Waypoint:
    """Pose sample along a robot trajectory (reference: :12-57)."""

    x: float
    y: float
    z: float
    yaw: float  # radians
    timestamp: float = 0.0
    velocity: Optional[float] = None
    angular_velocity: Optional[float] = None

    def to_array(self) -> np.ndarray:
        return np.array([self.x, self.y, self.z, self.yaw])

    def to_pose_matrix(self) -> np.ndarray:
        """4x4 pose: yaw-only Z rotation + translation (reference: :30-44)."""
        matrix = np.eye(4)
        matrix[0, 3] = self.x
        matrix[1, 3] = self.y
        matrix[2, 3] = self.z
        cos_yaw, sin_yaw = np.cos(self.yaw), np.sin(self.yaw)
        matrix[0, 0] = cos_yaw
        matrix[0, 1] = -sin_yaw
        matrix[1, 0] = sin_yaw
        matrix[1, 1] = cos_yaw
        return matrix

    def distance_to(self, other: "Waypoint") -> float:
        return float(
            np.sqrt(
                (self.x - other.x) ** 2
                + (self.y - other.y) ** 2
                + (self.z - other.z) ** 2
            )
        )

    def angle_to(self, other: "Waypoint") -> float:
        return float(np.arctan2(other.y - self.y, other.x - self.x))

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"Waypoint(x={self.x:.2f}, y={self.y:.2f}, z={self.z:.2f}, "
            f"yaw={self.yaw:.2f})"
        )


def waypoints_to_pose_batch(waypoints: List[Waypoint]) -> np.ndarray:
    """(W, 4, 4) pose stack for the fused multi-waypoint scan."""
    return np.stack([w.to_pose_matrix() for w in waypoints]).astype(np.float32)


@dataclass
class TrajectoryQuality:
    """Quality metrics for a trajectory (reference: :60-81)."""

    coverage_ratio: float
    path_length: float
    turn_count: int
    efficiency: float
    collision_count: int
    smoothness: float

    def to_dict(self) -> Dict[str, Any]:
        return {
            "coverage_ratio": self.coverage_ratio,
            "path_length": self.path_length,
            "turn_count": self.turn_count,
            "efficiency": self.efficiency,
            "collision_count": self.collision_count,
            "smoothness": self.smoothness,
        }


class TrajectoryGeneratorBase(ABC):
    """Common trajectory metrics/utilities (reference: :84-223)."""

    def __init__(self, room_bounds: Dict[str, float], robot_height: float = 1.0):
        self.room_bounds = room_bounds
        self.robot_height = robot_height
        self.robot_radius = 0.3

    @abstractmethod
    def generate_trajectory(self, **kwargs) -> Tuple[List[Waypoint], TrajectoryQuality]:
        ...

    def waypoints_to_poses(self, waypoints: List[Waypoint]) -> List[np.ndarray]:
        return [w.to_pose_matrix() for w in waypoints]

    def calculate_path_length(self, waypoints: List[Waypoint]) -> float:
        if len(waypoints) < 2:
            return 0.0
        pts = np.array([[w.x, w.y, w.z] for w in waypoints])
        return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())

    @staticmethod
    def _yaw_changes(waypoints: List[Waypoint]) -> np.ndarray:
        yaws = np.array([w.yaw for w in waypoints])
        changes = np.abs(np.diff(yaws))
        return np.where(changes > np.pi, 2 * np.pi - changes, changes)

    def count_turns(self, waypoints: List[Waypoint], angle_threshold: float = 0.1) -> int:
        if len(waypoints) < 3:
            return 0
        # Reference counts yaw changes between consecutive interior waypoints
        # (trajectory_generator.py:129-145).
        changes = self._yaw_changes(waypoints)[1:]
        return int(np.sum(changes > angle_threshold))

    def calculate_smoothness(self, waypoints: List[Waypoint]) -> float:
        """1 / (1 + std of yaw changes) (reference: :147-164)."""
        if len(waypoints) < 3:
            return 1.0
        changes = self._yaw_changes(waypoints)[1:]
        if len(changes) == 0:
            return 1.0
        return float(1.0 / (1.0 + np.std(changes)))

    def is_point_in_room(self, waypoint: Waypoint) -> bool:
        return (
            self.room_bounds["x_min"] <= waypoint.x <= self.room_bounds["x_max"]
            and self.room_bounds["y_min"] <= waypoint.y <= self.room_bounds["y_max"]
            and self.room_bounds["z_min"] <= waypoint.z <= self.room_bounds["z_max"]
        )

    def clip_to_room_bounds(self, waypoint: Waypoint) -> Waypoint:
        return Waypoint(
            x=float(np.clip(waypoint.x, self.room_bounds["x_min"], self.room_bounds["x_max"])),
            y=float(np.clip(waypoint.y, self.room_bounds["y_min"], self.room_bounds["y_max"])),
            z=float(np.clip(waypoint.z, self.room_bounds["z_min"], self.room_bounds["z_max"])),
            yaw=waypoint.yaw,
            timestamp=waypoint.timestamp,
            velocity=waypoint.velocity,
            angular_velocity=waypoint.angular_velocity,
        )

    def evaluate_trajectory_quality(
        self, waypoints: List[Waypoint], collision_count: int = 0
    ) -> TrajectoryQuality:
        path_length = self.calculate_path_length(waypoints)
        turn_count = self.count_turns(waypoints)
        smoothness = self.calculate_smoothness(waypoints)
        coverage_ratio = self._calculate_coverage_ratio(waypoints)
        efficiency = coverage_ratio / path_length if path_length > 0 else 0
        return TrajectoryQuality(
            coverage_ratio=coverage_ratio,
            path_length=path_length,
            turn_count=turn_count,
            efficiency=efficiency,
            collision_count=collision_count,
            smoothness=smoothness,
        )

    def _calculate_coverage_ratio(self, waypoints: List[Waypoint]) -> float:
        """Waypoint-bbox-area over room-area (reference: :206-223)."""
        if not waypoints:
            return 0.0
        positions = np.array([[w.x, w.y] for w in waypoints])
        covered = (positions[:, 0].max() - positions[:, 0].min()) * (
            positions[:, 1].max() - positions[:, 1].min()
        )
        room_area = (self.room_bounds["x_max"] - self.room_bounds["x_min"]) * (
            self.room_bounds["y_max"] - self.room_bounds["y_min"]
        )
        return float(min(covered / room_area, 1.0)) if room_area > 0 else 0.0
