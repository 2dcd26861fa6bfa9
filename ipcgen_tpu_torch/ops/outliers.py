"""Statistical outlier removal (port of ``ipcgen_tpu/ops/outliers.py``).

For each point, the mean distance to its ``nb_neighbors`` nearest
neighbours (itself excluded); points whose mean exceeds global_mean +
std_ratio * global_std are outliers.  The JAX package's semantics are kept
where they differ from Open3D's ``remove_statistical_outlier``: the
threshold is computed on the host over the finite means, a point whose
grid neighbourhood holds fewer than k references has a +inf mean and is an
outlier, and the fused path's PCA masks outlier neighbours instead of
reaching for the next inlier.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ipcgen_tpu_torch.ops.knn import knn
from ipcgen_tpu_torch.utils.device import device_or_card

# Below this size the exact k-NN is cheaper than building the hash grid;
# tests patch it to force the grid and fused paths on small clouds.
GRID_MIN_N = 150_000


def _threshold_mask(mean_dists: np.ndarray, std_ratio: float):
    """(inlier mask, threshold) from the host's float32 means, as the JAX
    package computes them."""
    finite = np.isfinite(mean_dists)
    mu = float(mean_dists[finite].mean())
    sigma = float(mean_dists[finite].std())
    threshold = mu + std_ratio * sigma
    return finite & (mean_dists <= threshold), threshold


def remove_statistical_outliers(
    points,
    nb_neighbors: int = 20,
    std_ratio: float = 2.0,
    *,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Statistical outlier removal on ``device`` (None: the card).

    Returns
    -------
    inlier_mask : (N,) bool, True for kept points.
    mean_dists : (N,) float32, mean k-NN distance per point.
    """
    device = device_or_card(device)
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    if n <= nb_neighbors:
        return np.ones(n, dtype=bool), np.zeros(n, dtype=np.float32)
    # k + 1: the query set is the reference set (self at distance 0).
    if n > GRID_MIN_N:
        from ipcgen_tpu_torch.ops.grid_nn import knn_grid

        _, d2 = knn_grid(points, points, k=nb_neighbors + 1, device_arrays=True,
                         device=device)
        mean_dists = torch.sqrt(d2[:, 1:]).mean(dim=1).cpu().numpy()
    else:
        _, dists = knn(points, points, k=nb_neighbors + 1, device=device)
        mean_dists = dists[:, 1:].mean(axis=1)
    mask, _ = _threshold_mask(mean_dists, std_ratio)
    return mask, mean_dists


def remove_outliers_and_estimate_normals(
    points,
    nb_neighbors: int = 20,
    std_ratio: float = 2.0,
    radius: float = 0.1,
    max_nn: int = 30,
    *,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Outlier removal and PCA normals from ONE grid self-join, on
    ``device`` (None: the card).

    One k = max(nb_neighbors + 1, max_nn) join serves both: the outlier
    means read the nearest ``nb_neighbors`` (self excluded), the PCA the
    nearest ``max_nn`` within ``radius`` with outlier neighbours masked.
    The inlier mask is the separate path's; normals differ only where an
    outlier sat among a point's ``max_nn`` neighbours.  At or below
    ``GRID_MIN_N`` points the separate path runs.

    Returns (inlier_mask (N,) bool, normals (mask.sum(), 3) float32 of the
    kept points, unit length, orientation-ambiguous).
    """
    from ipcgen_tpu_torch.ops.grid_nn import knn_grid
    from ipcgen_tpu_torch.ops.normals import estimate_normals

    device = device_or_card(device)
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    if n <= max(GRID_MIN_N, nb_neighbors, max_nn):
        mask, _ = remove_statistical_outliers(points, nb_neighbors, std_ratio,
                                              device=device)
        return mask, estimate_normals(points[mask], radius=radius, max_nn=max_nn,
                                      device=device)
    pts = torch.from_numpy(points).to(device)
    idx, d2 = knn_grid(pts, points, k=max(nb_neighbors + 1, max_nn),
                       device_arrays=True, device=device)
    mean_d = torch.sqrt(d2[:, 1:nb_neighbors + 1]).mean(dim=1)
    mask, threshold = _threshold_mask(mean_d.cpu().numpy(), std_ratio)
    normals = _fused_normals(pts, idx, d2, mean_d,
                             torch.tensor(np.float32(threshold), device=device),
                             max_nn, radius)
    return mask, normals[torch.from_numpy(mask).to(device)].cpu().numpy()


def _fused_normals(pts, idx, d2, mean_d, threshold, max_nn, radius):
    """PCA normals over the join's nearest ``max_nn`` candidates within
    ``radius``, with outlier neighbours (mean distance above ``threshold``,
    a float32 tensor, or non-finite) masked out of the covariance."""
    from ipcgen_tpu_torch.ops.normals import _pca_normals

    idx_n = idx[:, :max_nn]
    inlier = torch.isfinite(mean_d) & (mean_d <= threshold)
    valid = (d2[:, :max_nn] <= radius * radius) & inlier[idx_n]
    return _pca_normals(pts[idx_n], valid)
