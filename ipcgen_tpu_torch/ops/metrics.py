"""Distribution-similarity metrics as tiled reductions (port of
``ipcgen_tpu/ops/metrics.py``).

MMD with an RBF kernel, Chamfer and Hausdorff distances, and density, with
the reference's default sample sizes (10 k / 5 k / 3 k points).  Distances
are direct squared differences, (a_x - b_x)^2 + (a_y - b_y)^2 + (a_z -
b_z)^2, as in the port's ``ops/knn.py``: no product goes through a matmul,
so TF32 cannot reach them, and there is no cancellation of |a|^2 + |b|^2.
The JAX package takes the norm expansion at ``Precision.HIGHEST`` instead,
which carries a few float32 steps of |a|^2 + |b|^2 of error in each d2.
Both sides are tiled (4,096 reference points, 16,384 queries), so memory
stays bounded; the MMD's kernel sums accumulate in float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ipcgen_tpu_torch.utils.device import device_or_card

BLOCK = 4096  # reference points per tile
ROWS = 16384  # query points per tile of the directed distances


def _pairwise_d2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(n, m) squared distances between the rows of ``a`` and ``b``."""
    d2 = (a[:, None, 0] - b[None, :, 0]) ** 2
    d2 = d2 + (a[:, None, 1] - b[None, :, 1]) ** 2
    return d2 + (a[:, None, 2] - b[None, :, 2]) ** 2


def _kernel_mean(x: torch.Tensor, y: torch.Tensor, gamma: float) -> float:
    """Mean of exp(-gamma |x_i - y_j|^2) over all pairs, summed in float64."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for s in range(0, y.shape[0], BLOCK):
        total += torch.exp(-gamma * _pairwise_d2(x, y[s:s + BLOCK])).sum(dtype=torch.float64)
    return float(total) / (x.shape[0] * y.shape[0])


def _mmd_core(x: torch.Tensor, y: torch.Tensor, gamma: float) -> float:
    """Biased MMD^2 with an RBF kernel (reference formula,
    evaluate_single_scene.py:62-79)."""
    return _kernel_mean(x, x, gamma) + _kernel_mean(y, y, gamma) - 2 * _kernel_mean(x, y, gamma)


def _directed_min_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """min_j ||x_i - y_j|| for every i, tiled over x and y to bound memory."""
    best = torch.full((x.shape[0],), float("inf"), dtype=torch.float32, device=x.device)
    for r in range(0, x.shape[0], ROWS):
        xr = x[r:r + ROWS]
        for s in range(0, y.shape[0], BLOCK):
            best[r:r + ROWS] = torch.minimum(best[r:r + ROWS],
                                             _pairwise_d2(xr, y[s:s + BLOCK]).min(dim=1).values)
    return torch.sqrt(best)


def sample_points(points: np.ndarray, max_points: int = 10000,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Uniform subsample without replacement (reference: :47-53)."""
    if len(points) <= max_points:
        return points
    rng = rng or np.random.default_rng()
    idx = rng.choice(len(points), max_points, replace=False)
    return points[idx]


def _on(device, *clouds):
    return [torch.as_tensor(np.asarray(c, np.float32)).to(device) for c in clouds]


def compute_mmd(
    x: np.ndarray,
    y: np.ndarray,
    max_points: int = 10000,
    gamma: float = 1.0,
    rng: Optional[np.random.Generator] = None,
    *,
    device=None,
) -> float:
    """MMD with RBF kernel (reference: compute_mmd_sampled, :55-79), on
    ``device`` (None: the card)."""
    xs, ys = _on(device_or_card(device), sample_points(x, max_points, rng),
                 sample_points(y, max_points, rng))
    return _mmd_core(xs, ys, gamma)


def compute_chamfer_distance(
    x: np.ndarray,
    y: np.ndarray,
    max_points: int = 5000,
    rng: Optional[np.random.Generator] = None,
    *,
    device=None,
) -> float:
    """Symmetric Chamfer distance, mean+mean form (reference: :81-96)."""
    xs, ys = _on(device_or_card(device), sample_points(x, max_points, rng),
                 sample_points(y, max_points, rng))
    return float(_directed_min_dists(xs, ys).mean() + _directed_min_dists(ys, xs).mean())


def compute_hausdorff_distance(
    x: np.ndarray,
    y: np.ndarray,
    max_points: int = 3000,
    rng: Optional[np.random.Generator] = None,
    *,
    device=None,
) -> float:
    """Symmetric Hausdorff distance (reference: :98-111)."""
    xs, ys = _on(device_or_card(device), sample_points(x, max_points, rng),
                 sample_points(y, max_points, rng))
    return float(torch.maximum(_directed_min_dists(xs, ys).max(),
                               _directed_min_dists(ys, xs).max()))


def chamfer_distance_mean(x: np.ndarray, y: np.ndarray, max_points: int = 100000, *,
                          device=None) -> float:
    """(mean_xy + mean_yx)/2 variant used by the reconstruction evaluator
    (reference: s3dis_nksr_reconstructor.py:324-335)."""
    xs, ys = _on(device_or_card(device), sample_points(x, max_points),
                 sample_points(y, max_points))
    return float((_directed_min_dists(xs, ys).mean() + _directed_min_dists(ys, xs).mean())
                 / 2.0)


def density(points: np.ndarray) -> float:
    """Points per bounding-box volume (reference: :113-133)."""
    if len(points) == 0:
        return 0.0
    extent = points.max(axis=0) - points.min(axis=0)
    volume = float(np.prod(extent))
    return len(points) / volume if volume > 0 else 0.0
