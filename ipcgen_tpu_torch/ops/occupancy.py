"""Batched free-space / occupancy queries over the resident scene.

Port of ``ipcgen_tpu/ops/occupancy.py``.  Every planning-grid cell asks "is
any geometry within the robot radius?" by casting a small bundle of probe
rays from the cell centre and keeping the hits nearer than the radius: one
batched raycast for the whole grid.  It sees triangle surfaces, not just
vertices, and is the ``occupancy_mode="raycast"`` option of
``AutoTrajectoryGenerator`` (``"vertices"`` stays the default).

The default backend is the pair kernel with ``sort_rays="auto"``, what the
JAX package's ``backend="auto"`` runs on the TPU: 26 probe directions per
cell make incoherent tiles, so the raycast re-runs ray-sorted in 1024-ray
tiles.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ipcgen_tpu_torch.ops.raycast import raycast_asset
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset
from ipcgen_tpu_torch.utils.device import to_host


def _probe_directions(n_azimuth: int = 8, n_polar: int = 3) -> np.ndarray:
    """A small uniform bundle of probe directions (+/- vertical included)."""
    dirs = [np.array([0.0, 0.0, 1.0]), np.array([0.0, 0.0, -1.0])]
    for k in range(n_polar):
        theta = (k + 0.5) / n_polar * np.pi - np.pi / 2  # elevation
        for a in range(n_azimuth):
            phi = 2 * np.pi * a / n_azimuth
            dirs.append(
                np.array(
                    [
                        np.cos(theta) * np.cos(phi),
                        np.cos(theta) * np.sin(phi),
                        np.sin(theta),
                    ]
                )
            )
    return np.asarray(dirs, dtype=np.float32)


def obstacle_mask(
    asset: SceneAsset,
    cells: np.ndarray,
    robot_radius: float,
    directions: Optional[np.ndarray] = None,
    backend: str = "pairs",
) -> np.ndarray:
    """True where geometry lies within ``robot_radius`` of a cell centre.

    Parameters
    ----------
    cells : (N, 3) candidate cell centres (e.g. the planning grid at robot
        height).
    directions : optional (K, 3) probe bundle; defaults to 26 rays.
    backend : the port's raycast backend ("pairs", "culled" or "brute").
    """
    cells = np.asarray(cells, dtype=np.float32).reshape(-1, 3)
    if len(cells) == 0:
        return np.zeros(0, dtype=bool)
    if directions is None:
        directions = _probe_directions()
    k = len(directions)
    origins = np.repeat(cells, k, axis=0)
    dirs = np.tile(directions, (len(cells), 1))
    res = raycast_asset(origins, dirs, asset, backend=backend,
                        t_max=float(robot_radius))
    return to_host(res.hit).reshape(len(cells), k).any(axis=1)
