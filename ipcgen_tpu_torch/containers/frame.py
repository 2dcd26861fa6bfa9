"""Pose/frame containers: RobotPose, LidarPose, S3DISFrame.

API-parity rewrite of reference containers/s3dis_frame.py:11-207.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np


@dataclass
class RobotPose:
    """Robot pose: position + rotation matrix (reference: s3dis_frame.py:11-60)."""

    position: np.ndarray  # (3,)
    orientation: np.ndarray  # (3, 3)
    timestamp: float = 0.0
    velocity: Optional[np.ndarray] = None
    angular_velocity: Optional[np.ndarray] = None

    def to_matrix(self) -> np.ndarray:
        matrix = np.eye(4)
        matrix[:3, :3] = self.orientation
        matrix[:3, 3] = self.position
        return matrix

    @classmethod
    def from_matrix(cls, matrix: np.ndarray, timestamp: float = 0.0) -> "RobotPose":
        return cls(position=matrix[:3, 3], orientation=matrix[:3, :3], timestamp=timestamp)

    def get_yaw(self) -> float:
        return float(np.arctan2(self.orientation[1, 0], self.orientation[0, 0]))

    def get_pitch(self) -> float:
        return float(
            np.arctan2(
                -self.orientation[2, 0],
                np.sqrt(self.orientation[2, 1] ** 2 + self.orientation[2, 2] ** 2),
            )
        )

    def get_roll(self) -> float:
        return float(np.arctan2(self.orientation[2, 1], self.orientation[2, 2]))

    def to_dict(self) -> Dict[str, Any]:
        return {
            "position": np.asarray(self.position).tolist(),
            "orientation": np.asarray(self.orientation).tolist(),
            "timestamp": self.timestamp,
            "velocity": np.asarray(self.velocity).tolist() if self.velocity is not None else None,
            "angular_velocity": (
                np.asarray(self.angular_velocity).tolist()
                if self.angular_velocity is not None
                else None
            ),
        }


@dataclass
class LidarPose:
    """LiDAR sensor pose relative to the robot (reference: s3dis_frame.py:63-95)."""

    position: np.ndarray  # (3,)
    orientation: np.ndarray  # (3, 3)
    sensor_id: str = "lidar_0"

    def to_matrix(self) -> np.ndarray:
        matrix = np.eye(4)
        matrix[:3, :3] = self.orientation
        matrix[:3, 3] = self.position
        return matrix

    @classmethod
    def from_matrix(cls, matrix: np.ndarray, sensor_id: str = "lidar_0") -> "LidarPose":
        return cls(position=matrix[:3, 3], orientation=matrix[:3, :3], sensor_id=sensor_id)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "position": np.asarray(self.position).tolist(),
            "orientation": np.asarray(self.orientation).tolist(),
            "sensor_id": self.sensor_id,
        }


class S3DISFrame:
    """Multi-sensor frame container (reference: s3dis_frame.py:98-207)."""

    def __init__(
        self,
        frame_index: int,
        robot_pose: RobotPose,
        lidar_poses: Optional[Dict[str, LidarPose]] = None,
        frame_metadata: Optional[Dict[str, Any]] = None,
    ):
        self.frame_index = frame_index
        self.robot_pose = robot_pose
        self.lidar_poses = lidar_poses or {
            "lidar_0": LidarPose(position=np.zeros(3), orientation=np.eye(3))
        }
        self.frame_metadata = frame_metadata or {}

    def get_robot_pose_matrix(self) -> np.ndarray:
        return self.robot_pose.to_matrix()

    def get_lidar_pose_matrix(self, sensor_id: str = "lidar_0") -> np.ndarray:
        if sensor_id not in self.lidar_poses:
            raise ValueError(f"LiDAR sensor {sensor_id} does not exist")
        return self.lidar_poses[sensor_id].to_matrix()

    def get_global_lidar_pose(self, sensor_id: str = "lidar_0") -> np.ndarray:
        return self.get_robot_pose_matrix() @ self.get_lidar_pose_matrix(sensor_id)

    def get_timestamp(self) -> float:
        return self.robot_pose.timestamp

    def get_robot_position(self) -> np.ndarray:
        return self.robot_pose.position

    def get_robot_orientation(self) -> np.ndarray:
        return self.robot_pose.orientation

    def get_lidar_position(self, sensor_id: str = "lidar_0") -> np.ndarray:
        if sensor_id not in self.lidar_poses:
            raise ValueError(f"LiDAR sensor {sensor_id} does not exist")
        return self.lidar_poses[sensor_id].position

    def get_lidar_orientation(self, sensor_id: str = "lidar_0") -> np.ndarray:
        if sensor_id not in self.lidar_poses:
            raise ValueError(f"LiDAR sensor {sensor_id} does not exist")
        return self.lidar_poses[sensor_id].orientation

    def add_lidar_pose(self, sensor_id: str, lidar_pose: LidarPose) -> None:
        self.lidar_poses[sensor_id] = lidar_pose

    def remove_lidar_pose(self, sensor_id: str) -> None:
        self.lidar_poses.pop(sensor_id, None)

    def get_available_sensors(self) -> list:
        return list(self.lidar_poses.keys())

    def to_dict(self) -> Dict[str, Any]:
        return {
            "frame_index": self.frame_index,
            "robot_pose": self.robot_pose.to_dict(),
            "lidar_poses": {k: v.to_dict() for k, v in self.lidar_poses.items()},
            "frame_metadata": self.frame_metadata,
        }

    @classmethod
    def from_dict(cls, frame_dict: Dict[str, Any]) -> "S3DISFrame":
        rp = frame_dict["robot_pose"]
        robot_pose = RobotPose(
            position=np.array(rp["position"]),
            orientation=np.array(rp["orientation"]),
            timestamp=rp["timestamp"],
            velocity=np.array(rp["velocity"]) if rp.get("velocity") else None,
            angular_velocity=(
                np.array(rp["angular_velocity"]) if rp.get("angular_velocity") else None
            ),
        )
        lidar_poses = {
            sensor_id: LidarPose(
                position=np.array(d["position"]),
                orientation=np.array(d["orientation"]),
                sensor_id=sensor_id,
            )
            for sensor_id, d in frame_dict["lidar_poses"].items()
        }
        return cls(
            frame_index=frame_dict["frame_index"],
            robot_pose=robot_pose,
            lidar_poses=lidar_poses,
            frame_metadata=frame_dict.get("frame_metadata", {}),
        )

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"S3DISFrame(index={self.frame_index}, timestamp={self.get_timestamp():.3f}, "
            f"sensors={self.get_available_sensors()})"
        )
