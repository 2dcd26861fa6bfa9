"""Fused multi-waypoint LiDAR scan.

Port of ``ipcgen_tpu/sim/scan.py`` (:128-524).  The whole trajectory is one
batch: beam patterns, pose transforms, one raycast over every (waypoint, ray)
and the keep/range masks.  As in the JAX package, the ray order within a
waypoint follows the raycast backend (``scan_permutation``): the
candidate-pair kernel (``"pairs"``, the JAX package's mxu) wants angularly
tight tiles and gets PATCH order; the culled kernel (``"culled"``, JAX's
pallas and xla) and the oracle (``"brute"``) cast in beam order.
``"unordered"`` returns each waypoint's rays in that order, so its rows line
up with the JAX package's for the same backend.

Randomness is explicit: the scan core takes the sensor pattern, the keep
mask and the range-noise draws as tensors, and ``scan_waypoints`` draws them
from a ``torch.Generator``.  The JAX package's uint16 point quantization and
its device-resident pattern caches were remote-link workarounds and are not
ported.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ipcgen_tpu_torch.models import beams
from ipcgen_tpu_torch.models.lidar_intrinsics import (
    DualAxisLidarIntrinsics,
    Indoor8LineLidarIntrinsics,
)
from ipcgen_tpu_torch.ops.raycast import raycast_asset
from ipcgen_tpu_torch.ops.raycast_backends import BACKENDS, resolve_backend
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset
from ipcgen_tpu_torch.utils.device import to_host


@dataclass
class ScanBatch:
    """Fixed-shape multi-waypoint scan result (device tensors)."""

    points: torch.Tensor  # (W, R, 3) world hit points (0 where invalid)
    t: torch.Tensor  # (W, R) hit distance, +inf where invalid
    mask: torch.Tensor  # (W, R) valid hit (hit & kept & in range)
    incident_angles: torch.Tensor  # (W, R) degrees (reference formula)
    normals: torch.Tensor  # (W, R, 3) geometric surface normals
    true_incidence: torch.Tensor  # (W, R) degrees from surface normals

    @property
    def num_waypoints(self) -> int:
        return self.points.shape[0]

    @property
    def rays_per_scan(self) -> int:
        return self.points.shape[1]

    def frame_arrays(self, w: int):
        """One waypoint's hits as numpy (points, incident angles)."""
        m = to_host(self.mask[w])
        return to_host(self.points[w])[m], to_host(self.incident_angles[w])[m]

    def points_and_mask(self):
        """(points (W, R, 3), mask (W, R)) as numpy, in one copy each."""
        return to_host(self.points), to_host(self.mask)


def static_profile_dirs(intrinsics: Indoor8LineLidarIntrinsics, device) -> torch.Tensor:
    """(R, 3) sensor-frame pattern of a static grid profile."""
    if intrinsics.vertical_degrees is None:
        return beams.gen_uniform_grid_dirs(
            float(intrinsics.fov_up), float(intrinsics.fov_down),
            int(intrinsics.vertical_res), int(intrinsics.horizontal_res),
            device=device,
        )
    return beams.gen_vertical_degree_dirs(
        [float(v) for v in intrinsics.vertical_degrees],
        int(intrinsics.horizontal_res), device=device,
    )


def sensor_dirs_batch(intrinsics, num_waypoints: int,
                      generator: Optional[torch.Generator], device):
    """Per-waypoint sensor-frame beam directions + keep masks.

    Returns ``(dirs (WB, R, 3), keep (WB, R) bool or None)``: WB is 1 for
    static grid profiles (one pattern, no dropout: keep is None) and
    ``num_waypoints`` for the dual-axis scanner, which draws its angle noise
    and dropout anew for every waypoint from ``generator``.
    """
    if isinstance(intrinsics, DualAxisLidarIntrinsics):
        n = int(intrinsics.point_rate * intrinsics.scan_duration)
        dirs, keep = [], []
        for _ in range(num_waypoints):
            d, k = beams.gen_dual_axis_dirs(
                generator, n, int(intrinsics.num_vertical_lines),
                float(intrinsics.theta_range[0]),
                float(intrinsics.theta_range[1]),
                float(intrinsics.swing_amplitude),
                float(intrinsics.swing_frequency),
                float(intrinsics.angle_noise_std),
                float(intrinsics.dropout_probability),
                device=device,
            )
            dirs.append(d)
            keep.append(k)
        return torch.stack(dirs), torch.stack(keep)
    if isinstance(intrinsics, Indoor8LineLidarIntrinsics):
        return static_profile_dirs(intrinsics, device)[None], None
    raise ValueError(f"Unsupported LiDAR intrinsics type: {type(intrinsics)}")


@functools.lru_cache(maxsize=32)
def patch_permutation(h: int, w: int, lines_pp: int = 8,
                      az_pp: int = 128) -> np.ndarray:
    """Ray order whose consecutive rays form angular PATCHES of
    ``lines_pp`` lines x ``az_pp`` azimuth steps (the JAX package's order)."""
    line = np.repeat(np.arange(h), w)
    az = np.tile(np.arange(w), h)
    perm = np.lexsort(
        (az % az_pp, line % lines_pp, az // az_pp, line // lines_pp)
    ).astype(np.int32)
    perm.setflags(write=False)
    return perm


def scan_permutation(intrinsics, r: int, backend: str = "pairs"):
    """(perm, inv_perm) numpy pair: the order the scan casts its rays in.
    ``backend`` is a port name or a JAX name (``ops.raycast_backends``).
    Patch order for the pair kernel (the JAX package's order for its mxu
    kernel), the identity for every other backend."""
    if not BACKENDS[resolve_backend(backend)].patch_order:
        perm = np.arange(r, dtype=np.int32)
        return perm, perm
    if isinstance(intrinsics, Indoor8LineLidarIntrinsics):
        h = (len(intrinsics.vertical_degrees)
             if intrinsics.vertical_degrees is not None
             else intrinsics.vertical_res)
    elif isinstance(intrinsics, DualAxisLidarIntrinsics):
        h = int(intrinsics.num_vertical_lines)
    else:
        raise ValueError(f"Unsupported LiDAR intrinsics type: {type(intrinsics)}")
    perm = patch_permutation(h, r // h)
    return perm, np.argsort(perm).astype(np.int32)


def _world_rays(poses: torch.Tensor, dirs_sensor: torch.Tensor,
                perm: torch.Tensor):
    """(W, R, 3) world origins and directions in the scan's ray order."""
    w = poses.shape[0]
    r = dirs_sensor.shape[1]
    dirs_sp = dirs_sensor[:, perm]  # (WB, R, 3) in the scan's ray order
    dirs_wp = beams.dirs_to_world_batch(dirs_sp.expand(w, r, 3), poses)
    origins = poses[:, None, :3, 3].expand(w, r, 3)
    return origins, dirs_wp


def _scan_core(
    asset: SceneAsset,
    poses: torch.Tensor,
    dirs_sensor: torch.Tensor,
    keep: Optional[torch.Tensor],
    range_noise: Optional[torch.Tensor],
    perm: torch.Tensor,
    inv_perm: torch.Tensor,
    max_range: float,
    outputs: str = "full",
    backend: str = "pairs",
    cast=None,
) -> ScanBatch:
    """Everything after beam generation: pose transform, raycast in the
    order ``perm`` gives, range noise, keep and range masks, outputs.

    dirs_sensor (WB, R, 3) and keep (WB, R) are in BEAM order (WB = 1 or W);
    range_noise (W, R) holds the sigma-scaled draws in beam order, or None.
    ``cast(origins, dirs)``, when given, takes the place of ``raycast_asset``
    (the sharded scan's raycast, ``parallel/shard.py``).
    """
    if outputs not in ("full", "minimal", "unordered"):
        raise ValueError(f"unknown outputs mode {outputs!r}")
    w = poses.shape[0]
    r = dirs_sensor.shape[1]
    perm = perm.long()
    origins, dirs_wp = _world_rays(poses, dirs_sensor, perm)
    # The scan's order already makes the tiles coherent: no ray sort, as in
    # the JAX scan (whose "auto" sort is off under jit).
    if cast is None:
        res = raycast_asset(
            origins.reshape(w * r, 3), dirs_wp.reshape(w * r, 3), asset,
            backend=backend, t_max=max_range, sort_rays=False,
        )
    else:
        res = cast(origins.reshape(w * r, 3), dirs_wp.reshape(w * r, 3))
    t = res.t.view(w, r)
    hit = res.hit.view(w, r)
    points = res.points.view(w, r, 3)
    normals = res.normals.view(w, r, 3)

    if range_noise is not None:
        # Floor at a millimetre so close hits never mirror behind the sensor.
        t = torch.where(hit, torch.clamp(t + range_noise[:, perm], min=1e-3), t)
        points = origins + dirs_wp * t[..., None]

    mask = hit & (t < max_range)
    if keep is not None:
        mask = mask & keep[:, perm].expand(w, r)
    zero3 = torch.zeros_like(points)
    inf = torch.full_like(t, float("inf"))
    points = torch.where(mask[..., None], points, zero3)
    t = torch.where(mask, t, inf)
    if outputs in ("minimal", "unordered"):
        zero_wr = torch.zeros((w, r), dtype=torch.float32, device=t.device)
        if outputs == "minimal":
            inv = inv_perm.long()
            points, t, mask = points[:, inv], t[:, inv], mask[:, inv]
        return ScanBatch(points=points, t=t, mask=mask, incident_angles=zero_wr,
                         normals=torch.zeros_like(points),
                         true_incidence=zero_wr)
    incident = torch.rad2deg(torch.arccos(torch.clamp(dirs_wp[..., 2].abs(), 0.0, 1.0)))
    incident = torch.where(mask, incident, torch.zeros_like(incident))
    cos_true = torch.clamp(torch.sum(dirs_wp * normals, dim=-1).abs(), 0.0, 1.0)
    true_inc = torch.where(mask, torch.rad2deg(torch.arccos(cos_true)),
                           torch.zeros_like(cos_true))
    normals = torch.where(mask[..., None], normals, zero3)
    inv = inv_perm.long()
    return ScanBatch(
        points=points[:, inv], t=t[:, inv], mask=mask[:, inv],
        incident_angles=incident[:, inv], normals=normals[:, inv],
        true_incidence=true_inc[:, inv],
    )


def _draw_scan(intrinsics, poses, generator, device):
    """Poses as a tensor, the generator (seed 0 when None), and the first
    draws ``scan_waypoints`` makes from it: sensor pattern and keep mask."""
    poses = torch.as_tensor(np.asarray(poses, np.float32), device=device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dirs_sensor, keep = sensor_dirs_batch(intrinsics, poses.shape[0],
                                          generator, device)
    return poses, generator, dirs_sensor, keep


def scan_rays(intrinsics, poses, generator: Optional[torch.Generator], device,
              backend: str = "pairs"):
    """The rays ``scan_waypoints(..., backend=backend)`` casts, as it casts
    them.

    Returns ``(origins (W*R, 3), dirs (W*R, 3), keep (W*R,) bool or None)``,
    waypoint-major and in the backend's order within each waypoint: the
    order and tiling of the scan's one raycast.  Given a generator in the
    state ``scan_waypoints`` would get it, these are the scan's own rays.
    """
    poses, _, dirs_sensor, keep = _draw_scan(intrinsics, poses, generator, device)
    w, r = poses.shape[0], dirs_sensor.shape[1]
    perm = torch.tensor(scan_permutation(intrinsics, r, backend)[0],
                        device=device).long()
    origins, dirs = _world_rays(poses, dirs_sensor, perm)
    if keep is not None:
        keep = keep[:, perm].expand(w, r).reshape(-1)
    return (origins.reshape(-1, 3).contiguous(), dirs.reshape(-1, 3).contiguous(),
            keep)


def scan_waypoints(
    asset: SceneAsset,
    intrinsics,
    poses,
    generator: Optional[torch.Generator] = None,
    apply_range_noise: bool = False,
    outputs: str = "full",
    backend: str = "pairs",
) -> ScanBatch:
    """Scan the scene from every (W, 4, 4) waypoint pose in one batch.

    ``generator`` (on the asset's device; seed 0 when None) draws the
    dual-axis angle noise and dropout, then the range noise.  Hits at or
    beyond ``max_range`` are dropped; ``outputs`` is "full", "minimal"
    (points/t/mask only, beam order) or "unordered" (points/t/mask in the
    backend's ray order within each waypoint).  ``backend`` is the raycast
    backend of ``ops.raycast.raycast_asset``.
    """
    return _scan(asset, intrinsics, poses, generator, apply_range_noise, outputs,
                 backend)


def _scan(asset, intrinsics, poses, generator, apply_range_noise: bool,
          outputs: str, backend: str, cast=None) -> ScanBatch:
    """``scan_waypoints``, with ``_scan_core``'s ``cast``."""
    device = asset.device
    poses, generator, dirs_sensor, keep = _draw_scan(intrinsics, poses,
                                                     generator, device)
    w, r = poses.shape[0], dirs_sensor.shape[1]
    sigma = (float(getattr(intrinsics, "range_noise_std", 0.0))
             if apply_range_noise else 0.0)
    range_noise = None
    if sigma > 0.0:
        range_noise = torch.randn((w, r), generator=generator,
                                  device=device) * sigma
    perm, inv_perm = scan_permutation(intrinsics, r, backend)
    return _scan_core(
        asset, poses, dirs_sensor, keep, range_noise,
        torch.tensor(perm, device=device), torch.tensor(inv_perm, device=device),
        float(intrinsics.max_range), outputs, backend, cast,
    )
