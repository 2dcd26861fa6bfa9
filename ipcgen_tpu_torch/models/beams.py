"""Beam patterns (sensor frame) and the world transform, in torch.

Port of ``ipcgen_tpu/models/beams.py`` (:34-182).  The formulas are the same
closed forms; randomness comes from an explicit ``torch.Generator`` instead
of ``jax.random`` keys, so the dual-axis noise and dropout streams differ
from the JAX package's (tests inject the JAX draws where they compare the
two, and check the port's own draws by distribution).  The functions that
take a keyword-only ``device`` run on the card when it is None.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from ipcgen_tpu_torch.models.lidar_intrinsics import (
    DualAxisLidarIntrinsics,
    Indoor8LineLidarIntrinsics,
)
from ipcgen_tpu_torch.utils.device import device_or_card


def spherical_to_cartesian(alpha: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """Unit directions from elevation ``alpha`` and azimuth ``beta`` (radians)."""
    ca = torch.cos(alpha)
    return torch.stack(
        [ca * torch.cos(beta), ca * torch.sin(beta), torch.sin(alpha)], dim=-1
    )


def gen_uniform_grid_dirs(fov_up: float, fov_down: float, h: int, w: int,
                          device=None) -> torch.Tensor:
    """Uniform elevation/azimuth grid: (h*w, 3) float32, vertical-major."""
    h = max(1, int(h))
    w = max(1, int(w))
    v = torch.linspace(math.radians(fov_up), -math.radians(fov_down), h,
                       device=device)
    hz = torch.arange(w, device=device, dtype=torch.float32) * (2.0 * math.pi / w)
    alpha = v.repeat_interleave(w)
    beta = hz.repeat(h)
    return spherical_to_cartesian(alpha, beta).float()


def gen_vertical_degree_dirs(vertical_degrees: Optional[Sequence[float]], w: int,
                             device=None) -> torch.Tensor:
    """LiT-style grid with explicit per-line elevations: (H*w, 3) float32,
    line-major; azimuth beta = -(i - w/2) / w * 2*pi for column i."""
    w = max(1, int(w))
    if vertical_degrees is None or len(vertical_degrees) == 0:
        vertical_degrees = [0.0]
    h = len(vertical_degrees)
    i = torch.arange(w, device=device).repeat(h).float()
    alpha = torch.deg2rad(
        torch.tensor(list(vertical_degrees), dtype=torch.float32, device=device)
    ).repeat_interleave(w)
    beta = -(i - w / 2.0) / w * 2.0 * math.pi
    return spherical_to_cartesian(alpha, beta).float()


def gen_dual_axis_dirs(
    generator: torch.Generator,
    num_points: int,
    num_lines: int,
    theta_min: float,
    theta_max: float,
    swing_amplitude: float,
    swing_frequency: float,
    angle_noise_std: float,
    dropout_probability: float,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """32-line dual-axis spiral scan: (dirs (N, 3) float32, keep (N,) bool),
    line-major.  ``N = (num_points // num_lines) * num_lines``.

    Angle noise (phi, then theta) and the dropout uniforms are drawn from
    ``generator``, which must live on ``device``.
    """
    ppl = num_points // num_lines
    n = ppl * num_lines
    line_idx = torch.arange(num_lines, device=device).repeat_interleave(ppl)
    base_theta = torch.linspace(theta_max, theta_min, num_lines,
                                device=device)[line_idx]
    phase = line_idx.float() * math.pi / num_lines
    phi = (torch.arange(ppl, device=device, dtype=torch.float32)
           * (2.0 * math.pi / ppl)).repeat(num_lines)
    swing = swing_amplitude * torch.sin(swing_frequency * phi + phase)
    theta = torch.clamp(base_theta + swing, theta_min, theta_max)
    phi = phi + angle_noise_std * torch.randn(n, generator=generator,
                                              device=device)
    theta = theta + angle_noise_std * torch.randn(n, generator=generator,
                                                  device=device)
    dirs = spherical_to_cartesian(theta, phi).float()
    keep = torch.rand(n, generator=generator, device=device) > dropout_probability
    return dirs, keep


def dual_axis_dirs_from_intrinsics(
    intr: DualAxisLidarIntrinsics,
    generator: torch.Generator,
    num_points: Optional[int] = None,
    *,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dual-axis pattern of ``intr`` (``num_points`` rays, the profile's
    point_rate x scan_duration when None), drawn from ``generator`` on
    ``device`` (None: the card)."""
    if num_points is None:
        num_points = int(intr.point_rate * intr.scan_duration)
    return gen_dual_axis_dirs(
        generator,
        num_points,
        int(intr.num_vertical_lines),
        float(intr.theta_range[0]),
        float(intr.theta_range[1]),
        float(intr.swing_amplitude),
        float(intr.swing_frequency),
        float(intr.angle_noise_std),
        float(intr.dropout_probability),
        device=device_or_card(device),
    )


def sensor_dirs_from_intrinsics(
    intr, generator: Optional[torch.Generator] = None, *, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam directions of any profile on ``device`` (None: the card):
    (dirs (N, 3), keep (N,) bool).  The dual-axis profile draws from
    ``generator``, or from one seeded with 0 when None (the JAX package's
    ``PRNGKey(0)``); the grid profiles keep every ray."""
    device = device_or_card(device)
    if isinstance(intr, DualAxisLidarIntrinsics):
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        return dual_axis_dirs_from_intrinsics(intr, generator, device=device)
    if isinstance(intr, Indoor8LineLidarIntrinsics):
        if intr.vertical_degrees is None:
            dirs = gen_uniform_grid_dirs(intr.fov_up, intr.fov_down, intr.vertical_res,
                                         intr.horizontal_res, device=device)
        else:
            dirs = gen_vertical_degree_dirs(intr.vertical_degrees, intr.horizontal_res,
                                            device=device)
        return dirs, torch.ones(dirs.shape[0], dtype=torch.bool, device=device)
    raise ValueError(f"Unsupported LiDAR intrinsics type: {type(intr)}")


def dirs_to_world(dirs: torch.Tensor, pose) -> torch.Tensor:
    """Sensor-frame directions rotated into the world frame, d @ R^T (the
    reference transform, indoor_lidar.py:88, :127), in full float32 (TF32 is
    off package-wide).  ``pose`` (4, 4) is a tensor or an array."""
    rot = torch.as_tensor(pose, dtype=torch.float32, device=dirs.device)[:3, :3]
    return (dirs @ rot.T).float()


def rays_to_world(dirs: torch.Tensor, pose) -> torch.Tensor:
    """(N, 6) world rays [origin | direction] for one pose (the reference's
    ``get_rays()`` layout, indoor_lidar.py:27-53)."""
    d = dirs_to_world(dirs, pose)
    origin = torch.as_tensor(pose, dtype=torch.float32, device=dirs.device)[:3, 3]
    return torch.cat([origin.expand_as(d), d], dim=-1)


def dirs_to_world_batch(dirs: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """(W, N, 3) world directions d @ R^T for a batch of (W, 4, 4) poses,
    in full float32 (TF32 is off package-wide)."""
    return torch.einsum("wnk,wjk->wnj", dirs, poses[:, :3, :3]).float()
