"""k-NN PCA normal estimation (port of ``ipcgen_tpu/ops/normals.py``).

The k nearest neighbours of each point (the exact k-NN of ``ops/knn.py``, or
the grid-hashed k-NN of ``ops/grid_nn.py`` above ``GRID_MIN_N`` points), a
3x3 covariance per neighbourhood over the neighbours within ``radius`` (the
hybrid-radius search of Open3D's ``estimate_normals``, which the reference
calls with radius 0.1 and max_nn 30), and the eigenvector of its smallest
eigenvalue in closed form, batched and branch-free.  Normals are
orientation-ambiguous; ``orient_towards`` flips them toward a viewpoint.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ipcgen_tpu_torch.ops.knn import knn
from ipcgen_tpu_torch.utils.device import device_or_card

# Same grid-path threshold as ops.outliers; tests patch it.
GRID_MIN_N = 150_000


def _det3(b: torch.Tensor) -> torch.Tensor:
    return (b[:, 0, 0] * (b[:, 1, 1] * b[:, 2, 2] - b[:, 1, 2] * b[:, 2, 1])
            - b[:, 0, 1] * (b[:, 1, 0] * b[:, 2, 2] - b[:, 1, 2] * b[:, 2, 0])
            + b[:, 0, 2] * (b[:, 1, 0] * b[:, 2, 1] - b[:, 1, 1] * b[:, 2, 0]))


def _smallest_eigenvector_3x3(cov: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue for a batch (N, 3, 3) of
    symmetric matrices: the trigonometric closed form of the eigenvalue,
    then the largest cross product of two rows of (A - lambda I).  An
    isotropic neighbourhood (no nullspace direction) gives +z."""
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    q = cov.diagonal(dim1=1, dim2=2).sum(-1) / 3.0
    b = cov - q[:, None, None] * eye
    p = torch.sqrt(torch.clamp((b * b).sum(dim=(1, 2)) / 6.0, min=1e-30))
    r = torch.clamp(_det3(b) / (2.0 * p ** 3 + 1e-30), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    eig_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    m = cov - eig_min[:, None, None] * eye
    c = torch.stack([torch.linalg.cross(m[:, 0], m[:, 1]),
                     torch.linalg.cross(m[:, 0], m[:, 2]),
                     torch.linalg.cross(m[:, 1], m[:, 2])], dim=1)  # (N, 3, 3)
    best = torch.argmax((c * c).sum(-1), dim=1)
    v = c.gather(1, best[:, None, None].expand(-1, 1, 3))[:, 0]
    norm = torch.linalg.norm(v, dim=1, keepdim=True)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=v.dtype, device=v.device)
    return torch.where(norm > 1e-12, v / torch.clamp(norm, min=1e-12), z)


def _pca_normals(neighbors: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """neighbors (N, K, 3) positions, valid (N, K) inclusion mask -> (N, 3)
    unit normals."""
    w = valid.to(neighbors.dtype)[..., None]
    count = torch.clamp(w.sum(dim=1), min=1.0)
    mean = (neighbors * w).sum(dim=1) / count
    centered = (neighbors - mean[:, None, :]) * w
    cov = torch.einsum("nki,nkj->nij", centered, centered) / count[:, None]
    return _smallest_eigenvector_3x3(cov)


def estimate_normals(
    points,
    radius: float = 0.1,
    max_nn: int = 30,
    orient_towards: Optional[np.ndarray] = None,
    *,
    device=None,
) -> np.ndarray:
    """Unit normals by hybrid-radius k-NN PCA on ``device`` (None: the
    card); (N, 3) float32 numpy.  Parameters as the reference config's
    (``configs/s3dis_config.yaml:24-25``): radius 0.1 m, max_nn 30."""
    device = device_or_card(device)
    points = np.asarray(points, dtype=np.float32)
    n = len(points)
    if n == 0:
        return np.zeros((0, 3), dtype=np.float32)
    k = min(max_nn, n)
    pts = torch.from_numpy(points).to(device)
    if n > GRID_MIN_N:
        # The grid-hashed self-join at room scale; its results stay on the
        # device for the gather and the PCA.  Candidates beyond the radius
        # (+inf for sparse neighbourhoods too) are masked.
        from ipcgen_tpu_torch.ops.grid_nn import knn_grid

        idx, d2 = knn_grid(pts, points, k=k, device_arrays=True, device=device)
        valid = d2 <= radius * radius
    else:
        idx, dists = knn(pts, points, k=k, device=device)
        idx = torch.from_numpy(idx).to(device).long()
        valid = torch.from_numpy(dists).to(device) <= radius
    normals = _pca_normals(pts[idx], valid).cpu().numpy()
    if orient_towards is not None:
        to_view = np.asarray(orient_towards, dtype=np.float32) - points
        flip = np.sum(normals * to_view, axis=1) < 0
        normals[flip] = -normals[flip]
    return normals
