"""LiDAR sensor classes (port of ``ipcgen_tpu/models/lidar.py``; API of the
reference's lidar/indoor_lidar.py).

The classes keep the reference's numpy ``get_rays() -> (N, 6)`` contract and
expose the fixed-shape pattern the fused scan uses (``beam_directions``:
directions plus a keep mask, as tensors on the sensor's ``device``; None
means the card).

Where the JAX package takes a PRNG key, ``DualAxisLidar`` takes an integer
``seed``: ``beam_directions`` draws from a ``torch.Generator`` seeded with it
(or from the generator it is given), and the numpy noise of
``get_rays_sequence`` and ``add_noise_to_rays`` seeds ``default_rng`` from
the key data ``jax.random.PRNGKey(seed)`` would hold, ``[0, seed mod
2^32]``, so those draws equal the JAX package's for the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from ipcgen_tpu_torch.models import beams
from ipcgen_tpu_torch.models.lidar_intrinsics import (
    DualAxisLidarIntrinsics,
    Indoor8LineLidarIntrinsics,
)
from ipcgen_tpu_torch.utils.device import device_or_card


def _key_data(seed: int) -> np.ndarray:
    """The two uint32 words of ``jax.random.PRNGKey(seed)`` (64-bit mode
    off), for seeds in [-2^31, 2^32) as it accepts them."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 32):
        raise ValueError(f"seed {seed} is outside [-2**31, 2**32)")
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


@dataclass
class IndoorLidar:
    """Single-axis multi-line scanner (reference: indoor_lidar.py:11-143)."""

    intrinsics: Indoor8LineLidarIntrinsics
    pose: np.ndarray  # (4, 4)
    device: Any = field(default=None, kw_only=True)

    def __post_init__(self) -> None:
        assert isinstance(self.intrinsics, Indoor8LineLidarIntrinsics)
        self.pose = np.asarray(self.pose, dtype=np.float64)
        assert self.pose.shape == (4, 4)
        self.device = device_or_card(self.device)

    def beam_directions(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Sensor-frame unit dirs + keep mask (all True for this profile)."""
        return beams.sensor_dirs_from_intrinsics(self.intrinsics, device=self.device)

    def get_rays(self) -> np.ndarray:
        """(N, 6) float32 world rays [origin | unit direction]
        (reference contract: raycast_engine/raycast_engine.py:31-45)."""
        dirs, _ = self.beam_directions()
        return beams.rays_to_world(dirs, self.pose).cpu().numpy()

    def get_total_rays(self) -> int:
        return self.intrinsics.get_total_points_per_scan()

    def get_scan_frequency(self) -> float:
        return self.intrinsics.get_scan_frequency()

    def get_range_limits(self) -> tuple:
        return self.intrinsics.get_range_limits()


@dataclass
class DualAxisLidar:
    """Dual-axis spiral scanner (reference: indoor_lidar.py:146-369)."""

    intrinsics: DualAxisLidarIntrinsics
    pose: np.ndarray  # (4, 4)
    seed: int = 0
    device: Any = field(default=None, kw_only=True)

    def __post_init__(self) -> None:
        assert isinstance(self.intrinsics, DualAxisLidarIntrinsics)
        self.pose = np.asarray(self.pose, dtype=np.float64)
        assert self.pose.shape == (4, 4)
        self.device = device_or_card(self.device)
        self._key = _key_data(self.seed)
        self._draws = 0

    def _np_rng(self, salt: int = 0) -> np.random.Generator:
        """Deterministic numpy Generator from the seed's key data.

        A per-instance draw counter enters the seed so successive calls get
        fresh, independent noise, while two instances with the same seed
        replay the same sequence (the JAX package's seeding, bit for bit).
        """
        self._draws += 1
        return np.random.default_rng(
            np.concatenate([self._key, [salt, self._draws]]).astype(np.uint32)
        )

    # ------------------------------------------------------------------
    def beam_directions(
        self, num_points: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fixed-shape sensor-frame dirs + dropout keep mask, drawn from
        ``generator`` (on the sensor's device), or from one seeded with
        ``seed`` when None, so every call without one gives the same rays."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(int(self.seed))
        return beams.dual_axis_dirs_from_intrinsics(
            self.intrinsics, generator, num_points, device=self.device)

    def get_multi_line_rays(self, num_points: Optional[int] = None) -> np.ndarray:
        """32-line dual-axis scan rays, dropout applied by compaction for
        parity with the reference output shape (indoor_lidar.py:224-296)."""
        dirs, keep = self.beam_directions(num_points)
        return beams.rays_to_world(dirs, self.pose)[keep].cpu().numpy()

    def get_rays(self) -> np.ndarray:
        return self.get_multi_line_rays()

    def get_rays_at_time(self, t: float) -> np.ndarray:
        """(1, 6) single ray at time t (reference: :162-190)."""
        phi, theta = self.intrinsics.calculate_angles_at_time(t, line_idx=0)
        direction = np.array(
            [np.cos(theta) * np.cos(phi), np.cos(theta) * np.sin(phi), np.sin(theta)],
            dtype=np.float32,
        )
        direction_world = (self.pose[:3, :3] @ direction).astype(np.float32)
        origin_world = self.pose[:3, 3].astype(np.float32)
        return np.concatenate([origin_world, direction_world]).reshape(1, 6)

    def get_rays_sequence(self, time_sequence: np.ndarray) -> np.ndarray:
        """(N, 6) rays for a time sequence, vectorized
        (reference loop: :192-222)."""
        ts = np.asarray(time_sequence, dtype=np.float64)
        phi = (self.intrinsics.phi_0 + self.intrinsics.omega_phi * ts) % (2 * np.pi)
        base = np.linspace(
            self.intrinsics.theta_range[1],
            self.intrinsics.theta_range[0],
            self.intrinsics.num_vertical_lines,
        )[0]
        swing = self.intrinsics.swing_amplitude * np.sin(
            self.intrinsics.swing_frequency * ts
        )
        theta = np.clip(
            base + swing, self.intrinsics.theta_range[0], self.intrinsics.theta_range[1]
        )
        if self.intrinsics.angle_noise_std > 0:
            rng = self._np_rng(salt=1)
            phi = phi + rng.normal(0, self.intrinsics.angle_noise_std, phi.shape)
            theta = theta + rng.normal(0, self.intrinsics.angle_noise_std, theta.shape)
        dirs = np.stack(
            [np.cos(theta) * np.cos(phi), np.cos(theta) * np.sin(phi), np.sin(theta)],
            axis=1,
        )
        dirs_world = dirs @ self.pose[:3, :3].T
        origins = np.broadcast_to(self.pose[:3, 3], dirs_world.shape)
        return np.concatenate([origins, dirs_world], axis=1).astype(np.float32)

    def get_rays_frame(self, frame_duration: Optional[float] = None) -> np.ndarray:
        return self.get_rays_sequence(
            self.intrinsics.generate_time_sequence(frame_duration)
        )

    def get_spiral_scan_rays(self, num_points: Optional[int] = None):
        if num_points is None:
            num_points = int(self.intrinsics.point_rate * self.intrinsics.scan_duration)
        timestamps = np.linspace(0, self.intrinsics.scan_duration, num_points)
        return self.get_rays_sequence(timestamps), timestamps

    def get_total_rays(self) -> int:
        return int(self.intrinsics.point_rate * self.intrinsics.scan_duration)

    def get_scan_frequency(self) -> float:
        return 1.0 / self.intrinsics.scan_duration

    def get_range_limits(self) -> tuple:
        return (0.5, self.intrinsics.max_range)

    def add_noise_to_rays(self, rays: np.ndarray) -> np.ndarray:
        if self.intrinsics.dropout_probability > 0:
            rng = self._np_rng(salt=2)
            keep = rng.random(len(rays)) > self.intrinsics.dropout_probability
            rays = rays[keep]
        return rays


LidarType = Union[IndoorLidar, DualAxisLidar]
IntrinsicsType = Union[Indoor8LineLidarIntrinsics, DualAxisLidarIntrinsics]


def create_lidar(intrinsics: IntrinsicsType, pose: np.ndarray, seed: int = 0, *,
                 device=None) -> LidarType:
    """Factory (reference: indoor_lidar.py:377-393); ``seed`` takes the
    place of the JAX package's ``rng_key``."""
    if isinstance(intrinsics, DualAxisLidarIntrinsics):
        return DualAxisLidar(intrinsics=intrinsics, pose=pose, seed=seed, device=device)
    if isinstance(intrinsics, Indoor8LineLidarIntrinsics):
        return IndoorLidar(intrinsics=intrinsics, pose=pose, device=device)
    raise ValueError(f"Unsupported LiDAR intrinsics type: {type(intrinsics)}")


def get_lidar_type(intrinsics: IntrinsicsType) -> str:
    """Human-readable profile name (reference: indoor_lidar.py:396-414)."""
    if isinstance(intrinsics, DualAxisLidarIntrinsics):
        return "Dual-axis spiral scanning"
    if isinstance(intrinsics, Indoor8LineLidarIntrinsics):
        if getattr(intrinsics, "dual_axis", False):
            return "Single-axis simulated dual-axis"
        return f"{intrinsics.vertical_res}-line single-axis scanning"
    return "Unknown type"
