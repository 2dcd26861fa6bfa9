"""Raycast engine facade (port of ``ipcgen_tpu/sim/engine.py``).

- ``RaycastEngineCPU``: the block-scan oracle (the JAX package's
  ``raycast_asset_xla``) on CPU tensors.
- ``RaycastEngineGPU``: the candidate-pair raycast on a CUDA device, whose
  inner loop is the CUDA kernel.  There is no fallback: without a card it
  raises where the kernel is launched.

Engines cache the scene asset per mesh object; call ``clear_cache()`` after
mutating a mesh in place.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ipcgen_tpu_torch.ops.raycast import raycast_asset
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset, build_scene_asset
from ipcgen_tpu_torch.utils.device import to_host


class RaycastEngineBase:
    """Shared engine logic; subclasses fix the device and backend."""

    device = "cpu"
    backend = "brute"

    def __init__(self) -> None:
        self._asset_cache: Dict[int, SceneAsset] = {}

    def clear_cache(self) -> None:
        self._asset_cache.clear()

    def asset_for_mesh(self, mesh) -> SceneAsset:
        asset = self._asset_cache.get(id(mesh))
        if asset is None:
            asset = build_scene_asset(np.asarray(mesh.vertices),
                                      np.asarray(mesh.triangles),
                                      device=self.device)
            self._asset_cache[id(mesh)] = asset
        return asset

    def _raycast(self, origins, dirs, asset) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        res = raycast_asset(torch.from_numpy(origins), torch.from_numpy(dirs),
                            asset, backend=self.backend)
        return to_host(res.t), to_host(res.hit), to_host(res.points)

    def rays_intersect_mesh(self, rays: np.ndarray, mesh) -> np.ndarray:
        """Intersect (N, 6) rays with a mesh; returns the hit points."""
        if not isinstance(rays, np.ndarray):
            raise TypeError("rays must be a numpy array.")
        if rays.ndim != 2 or rays.shape[1] != 6:
            raise ValueError("rays must be a (N, 6) array.")
        rays = rays.astype(np.float32)
        origins = np.ascontiguousarray(rays[:, :3])
        dirs = rays[:, 3:]
        dirs = np.ascontiguousarray(
            dirs / np.maximum(np.linalg.norm(dirs, axis=1, keepdims=True), 1e-12))
        _, hit, points = self._raycast(origins, dirs, self.asset_for_mesh(mesh))
        return points[hit]

    def lidar_intersect_mesh(self, lidar, mesh) -> Tuple[np.ndarray, np.ndarray]:
        """A LiDAR's rays against a mesh, hits beyond its ``max_range``
        dropped; returns (points (M, 3), incident angles (M,) in degrees
        from the vertical) (reference: raycast_engine_cpu.py:75-111)."""
        points = self.rays_intersect_mesh(rays=lidar.get_rays(), mesh=mesh)
        lidar_center = np.asarray(lidar.pose[:3, 3])
        point_dists = np.linalg.norm(points - lidar_center, axis=1)
        points = points[point_dists < lidar.intrinsics.max_range]
        if len(points) == 0:
            return points, np.empty(0)
        directions = points - lidar_center
        directions = directions / np.linalg.norm(directions, axis=1, keepdims=True)
        return points, np.degrees(np.arccos(np.abs(directions[:, 2])))


class RaycastEngineCPU(RaycastEngineBase):
    """The block-scan oracle on the CPU."""

    device = "cpu"
    backend = "brute"


class RaycastEngineGPU(RaycastEngineBase):
    """Candidate-pair raycast through the CUDA kernel."""

    backend = "pairs"

    def __init__(self, device="cuda") -> None:
        super().__init__()
        self.device = device
