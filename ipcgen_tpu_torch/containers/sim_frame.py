"""Simulation frame containers: ScanQuality, IncidentAngles, S3DISSimFrame.

API-parity rewrite of reference containers/s3dis_sim_frame.py:11-233.

Note on shapes: on the TPU the scan pipeline is fixed-shape with a hit mask;
these host containers hold the *compacted* per-frame results that downstream
exporters consume, exactly like the reference does.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np


@dataclass
class ScanQuality:
    """Per-frame scan quality metrics (reference: s3dis_sim_frame.py:11-40)."""

    coverage_ratio: float
    num_points: int
    incident_angle_mean: float
    incident_angle_std: float
    scan_density: float
    range_mean: float
    range_std: float
    # True sensor-range stats from the hit distances.  The reference's
    # range_mean/std are norms of WORLD coordinates (a preserved reference
    # quirk, s3dis_simulator.py:276-284); these fields dual-report the
    # physically meaningful quantity, mirroring the incident-angle /
    # true-incidence pattern.  The simulator always populates them, so
    # exported dicts carry the extra keys unless a caller explicitly sets
    # them to None (e.g. when regenerating reference-shaped fixtures).
    sensor_range_mean: Optional[float] = None
    sensor_range_std: Optional[float] = None

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "coverage_ratio": self.coverage_ratio,
            "num_points": self.num_points,
            "incident_angle_mean": self.incident_angle_mean,
            "incident_angle_std": self.incident_angle_std,
            "scan_density": self.scan_density,
            "range_mean": self.range_mean,
            "range_std": self.range_std,
        }
        if self.sensor_range_mean is not None:
            d["sensor_range_mean"] = self.sensor_range_mean
            d["sensor_range_std"] = self.sensor_range_std
        return d

    @classmethod
    def from_dict(cls, quality_dict: Dict[str, Any]) -> "ScanQuality":
        return cls(**quality_dict)


@dataclass
class IncidentAngles:
    """Incident angle info per point (reference: s3dis_sim_frame.py:43-81)."""

    angles: np.ndarray  # (N,)
    surface_normals: Optional[np.ndarray] = None  # (N, 3)
    ray_directions: Optional[np.ndarray] = None  # (N, 3)

    def get_mean_angle(self) -> float:
        return float(np.mean(self.angles)) if len(self.angles) else 0.0

    def get_std_angle(self) -> float:
        return float(np.std(self.angles)) if len(self.angles) else 0.0

    def get_angle_distribution(self, num_bins: int = 20):
        hist, bins = np.histogram(self.angles, bins=num_bins)
        return hist, bins

    def to_dict(self) -> Dict[str, Any]:
        return {
            "angles": np.asarray(self.angles).tolist(),
            "surface_normals": (
                np.asarray(self.surface_normals).tolist()
                if self.surface_normals is not None
                else None
            ),
            "ray_directions": (
                np.asarray(self.ray_directions).tolist()
                if self.ray_directions is not None
                else None
            ),
        }

    @classmethod
    def from_dict(cls, angles_dict: Dict[str, Any]) -> "IncidentAngles":
        return cls(
            angles=np.array(angles_dict["angles"]),
            surface_normals=(
                np.array(angles_dict["surface_normals"])
                if angles_dict.get("surface_normals")
                else None
            ),
            ray_directions=(
                np.array(angles_dict["ray_directions"])
                if angles_dict.get("ray_directions")
                else None
            ),
        )


class S3DISSimFrame:
    """One simulated scan frame (reference: s3dis_sim_frame.py:84-233)."""

    def __init__(
        self,
        frame_index: int,
        points: np.ndarray,
        incident_angles: np.ndarray,
        scan_quality: ScanQuality,
        frame_metadata: Optional[Dict[str, Any]] = None,
    ):
        self.frame_index = frame_index
        self.points = np.asarray(points)
        self.incident_angles = np.asarray(incident_angles)
        self.scan_quality = scan_quality
        self.frame_metadata = frame_metadata or {}

        if len(self.points) != len(self.incident_angles):
            raise ValueError(
                f"Point cloud count ({len(self.points)}) does not match "
                f"incident angle count ({len(self.incident_angles)})"
            )

    def get_num_points(self) -> int:
        return len(self.points)

    def get_coverage_ratio(self) -> float:
        return self.scan_quality.coverage_ratio

    def get_scan_density(self) -> float:
        return self.scan_quality.scan_density

    def get_mean_incident_angle(self) -> float:
        return self.scan_quality.incident_angle_mean

    def get_incident_angle_std(self) -> float:
        return self.scan_quality.incident_angle_std

    def get_mean_range(self) -> float:
        return self.scan_quality.range_mean

    def get_range_std(self) -> float:
        return self.scan_quality.range_std

    def get_point_cloud_bounds(self) -> Dict[str, float]:
        if len(self.points) == 0:
            return {k: 0 for k in ("x_min", "x_max", "y_min", "y_max", "z_min", "z_max")}
        return {
            "x_min": float(self.points[:, 0].min()),
            "x_max": float(self.points[:, 0].max()),
            "y_min": float(self.points[:, 1].min()),
            "y_max": float(self.points[:, 1].max()),
            "z_min": float(self.points[:, 2].min()),
            "z_max": float(self.points[:, 2].max()),
        }

    def get_point_cloud_center(self) -> np.ndarray:
        if len(self.points) == 0:
            return np.zeros(3)
        return np.mean(self.points, axis=0)

    def get_point_cloud_std(self) -> np.ndarray:
        if len(self.points) == 0:
            return np.zeros(3)
        return np.std(self.points, axis=0)

    def _rebuild_quality(self, points: np.ndarray, angles: np.ndarray) -> ScanQuality:
        """Re-derive quality after filtering (reference semantics:
        coverage/density rescaled by the kept fraction; range stats are norms
        of the point positions — s3dis_sim_frame.py:164-172)."""
        n_old = max(len(self.points), 1)
        frac = len(points) / n_old
        ranges = np.linalg.norm(points, axis=1) if len(points) else np.zeros(0)
        return ScanQuality(
            coverage_ratio=self.scan_quality.coverage_ratio * frac,
            num_points=len(points),
            incident_angle_mean=float(np.mean(angles)) if len(angles) else 0,
            incident_angle_std=float(np.std(angles)) if len(angles) else 0,
            scan_density=self.scan_quality.scan_density * frac,
            range_mean=float(np.mean(ranges)) if len(points) else 0,
            range_std=float(np.std(ranges)) if len(points) else 0,
        )

    def filter_points_by_angle(
        self, min_angle: float = 0, max_angle: float = np.pi / 2
    ) -> "S3DISSimFrame":
        mask = (self.incident_angles >= min_angle) & (self.incident_angles <= max_angle)
        pts, ang = self.points[mask], self.incident_angles[mask]
        return S3DISSimFrame(
            frame_index=self.frame_index,
            points=pts,
            incident_angles=ang,
            scan_quality=self._rebuild_quality(pts, ang),
            frame_metadata=self.frame_metadata.copy(),
        )

    def filter_points_by_range(
        self, min_range: float = 0, max_range: float = float("inf")
    ) -> "S3DISSimFrame":
        ranges = np.linalg.norm(self.points, axis=1)
        mask = (ranges >= min_range) & (ranges <= max_range)
        pts, ang = self.points[mask], self.incident_angles[mask]
        return S3DISSimFrame(
            frame_index=self.frame_index,
            points=pts,
            incident_angles=ang,
            scan_quality=self._rebuild_quality(pts, ang),
            frame_metadata=self.frame_metadata.copy(),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "frame_index": self.frame_index,
            "points": self.points.tolist(),
            "incident_angles": self.incident_angles.tolist(),
            "scan_quality": self.scan_quality.to_dict(),
            "frame_metadata": self.frame_metadata,
        }

    @classmethod
    def from_dict(cls, frame_dict: Dict[str, Any]) -> "S3DISSimFrame":
        return cls(
            frame_index=frame_dict["frame_index"],
            points=np.array(frame_dict["points"]),
            incident_angles=np.array(frame_dict["incident_angles"]),
            scan_quality=ScanQuality.from_dict(frame_dict["scan_quality"]),
            frame_metadata=frame_dict.get("frame_metadata", {}),
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"S3DISSimFrame(index={self.frame_index}, points={self.get_num_points()}, "
            f"coverage={self.get_coverage_ratio():.3f}, "
            f"mean_angle={self.get_mean_incident_angle():.3f})"
        )
