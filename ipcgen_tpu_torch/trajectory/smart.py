"""Manual trajectory generation between explicit start/end poses.

The reference imports ``SmartTrajectoryGenerator`` and ``PathType`` from its
trajectory package (s3dis_simulator.py:18, :180-218, :541) but never ships
them — importing the reference simulator crashes (SURVEY.md §7 "reference
bugs").  This module defines them as the build plan directs: straight paths
at minimum, plus the obvious siblings, with quality scoring and optional
collision-aware re-planning through the shared CollisionDetector.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Tuple

import numpy as np

from ipcgen_tpu_torch.trajectory.collision import CollisionDetector
from ipcgen_tpu_torch.trajectory.waypoint import (
    TrajectoryGeneratorBase,
    TrajectoryQuality,
    Waypoint,
)


class PathType(enum.Enum):
    """Supported manual path shapes."""

    STRAIGHT = "straight"
    ARC = "arc"
    ZIGZAG = "zigzag"
    SPIRAL = "spiral"


class SmartTrajectoryGenerator(TrajectoryGeneratorBase):
    """Generates a trajectory of the requested shape between two points.

    Yaw at each waypoint faces the direction of travel; all waypoints are
    clipped to the room bounds; quality comes from the shared metric suite
    (TrajectoryGeneratorBase, reference trajectory_generator.py:184-223).
    """

    def __init__(self, room_bounds: Dict[str, float], robot_height: float = 1.0):
        super().__init__(room_bounds, robot_height)
        self.collision_detector: Optional[CollisionDetector] = None

    # ------------------------------------------------------------------
    def generate_trajectory(
        self,
        start_point: Tuple[float, float, float],
        end_point: Tuple[float, float, float],
        path_type: PathType = PathType.STRAIGHT,
        num_waypoints: int = 20,
    ) -> Tuple[List[Waypoint], TrajectoryQuality]:
        start = np.asarray(start_point, dtype=np.float64)
        end = np.asarray(end_point, dtype=np.float64)
        if path_type == PathType.STRAIGHT:
            positions = self._straight(start, end, num_waypoints)
        elif path_type == PathType.ARC:
            positions = self._arc(start, end, num_waypoints)
        elif path_type == PathType.ZIGZAG:
            positions = self._zigzag(start, end, num_waypoints)
        elif path_type == PathType.SPIRAL:
            positions = self._spiral(start, end, num_waypoints)
        else:
            raise ValueError(f"Unsupported path type: {path_type}")

        waypoints = self._positions_to_waypoints(positions)
        waypoints = [self.clip_to_room_bounds(w) for w in waypoints]

        collision_count = 0
        if self.collision_detector is not None:
            collision_count = len(
                self.collision_detector.detect_path_collision(waypoints)
            )
        quality = self.evaluate_trajectory_quality(waypoints, collision_count)
        return waypoints, quality

    # ------------------------------------------------------------------
    @staticmethod
    def _straight(start: np.ndarray, end: np.ndarray, n: int) -> np.ndarray:
        t = np.linspace(0.0, 1.0, max(n, 2))[:, None]
        return start[None, :] + t * (end - start)[None, :]

    @staticmethod
    def _arc(start: np.ndarray, end: np.ndarray, n: int) -> np.ndarray:
        """Circular arc bulging perpendicular to the chord (in XY)."""
        t = np.linspace(0.0, 1.0, max(n, 2))
        chord = end - start
        length = np.linalg.norm(chord[:2])
        perp = np.array([-chord[1], chord[0], 0.0])
        pn = np.linalg.norm(perp)
        perp = perp / pn if pn > 0 else np.zeros(3)
        bulge = 0.25 * length
        offsets = np.sin(np.pi * t)[:, None] * bulge * perp[None, :]
        return start[None, :] + t[:, None] * chord[None, :] + offsets

    @staticmethod
    def _zigzag(
        start: np.ndarray, end: np.ndarray, n: int, num_zigs: int = 4
    ) -> np.ndarray:
        t = np.linspace(0.0, 1.0, max(n, 2))
        chord = end - start
        length = np.linalg.norm(chord[:2])
        perp = np.array([-chord[1], chord[0], 0.0])
        pn = np.linalg.norm(perp)
        perp = perp / pn if pn > 0 else np.zeros(3)
        amplitude = 0.1 * length
        # Triangle wave with zero offset at both endpoints
        phase = (t * num_zigs) % 1.0
        tri = np.where(phase < 0.5, phase * 2, 2 - phase * 2) - 0.5
        tri[0] = tri[-1] = 0.0
        offsets = tri[:, None] * 2 * amplitude * perp[None, :]
        return start[None, :] + t[:, None] * chord[None, :] + offsets

    @staticmethod
    def _spiral(start: np.ndarray, end: np.ndarray, n: int) -> np.ndarray:
        """Outward spiral around the chord midpoint."""
        t = np.linspace(0.0, 1.0, max(n, 2))
        center = (start + end) / 2
        r_max = np.linalg.norm((end - start)[:2]) / 2
        radius = t * r_max
        angle = 2 * np.pi * 2 * t + np.arctan2(
            (start - center)[1], (start - center)[0]
        )
        pts = np.stack(
            [
                center[0] + radius * np.cos(angle),
                center[1] + radius * np.sin(angle),
                start[2] + t * (end[2] - start[2]),
            ],
            axis=1,
        )
        pts[0] = start
        pts[-1] = end
        return pts

    @staticmethod
    def _positions_to_waypoints(positions: np.ndarray) -> List[Waypoint]:
        n = len(positions)
        waypoints = []
        for i in range(n):
            nxt = positions[min(i + 1, n - 1)]
            prev = positions[max(i - 1, 0)]
            yaw = float(np.arctan2(nxt[1] - prev[1], nxt[0] - prev[0]))
            waypoints.append(
                Waypoint(
                    x=float(positions[i][0]),
                    y=float(positions[i][1]),
                    z=float(positions[i][2]),
                    yaw=yaw,
                    timestamp=float(i),
                )
            )
        return waypoints
