"""Point+normal -> truncated signed distance field fusion (port of
``ipcgen_tpu/ops/sdf.py``).

The compute core of the surface-reconstruction substitute for NKSR: a
splatting IMLS.  Every input point adds, to the voxels of a (2r+1)^3
neighbourhood around it, the signed distance of the voxel centre to the
point's tangent plane, weighted by a Gaussian in the point-to-voxel
distance.  Accumulation is a pair of ``index_add_`` calls on flat voxel ids
per chunk of points: O(N * (2r+1)^3) with no neighbour search.

On the card ``index_add_`` adds with float atomics, so the order of the
additions, and the last bits of each sum, vary from run to run; the JAX
package's ``.at[].add`` sums in another order again.  Grids are compared
within a tolerance, never bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ipcgen_tpu_torch.utils.device import device_or_card

# Points per splat chunk: a chunk holds (chunk, (2r+1)^3) ids and weights.
FUSE_CHUNK = 65536


@dataclass
class SdfGrid:
    """Fused SDF volume on one device."""

    sdf: torch.Tensor  # (X, Y, Z) float32 signed distances (0 where invalid)
    weight: torch.Tensor  # (X, Y, Z) float32 accumulated weights
    origin: np.ndarray  # (3,) float32 world position of voxel (0,0,0) center
    voxel_size: float

    @property
    def shape(self) -> Tuple[int, int, int]:
        return tuple(self.sdf.shape)

    def valid(self, min_weight: float = 1e-3) -> torch.Tensor:
        return self.weight > min_weight

    @classmethod
    def from_numpy(cls, sdf, weight, origin, voxel_size: float, *, device=None) -> "SdfGrid":
        """A grid from host arrays (for example a JAX ``SdfGrid``'s), on
        ``device`` (None: the card)."""
        device = device_or_card(device)
        return cls(sdf=torch.from_numpy(np.array(sdf, np.float32)).to(device),
                   weight=torch.from_numpy(np.array(weight, np.float32)).to(device),
                   origin=np.asarray(origin, np.float32), voxel_size=float(voxel_size))

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
        """(sdf, weight, origin, voxel_size) as host arrays."""
        return (self.sdf.cpu().numpy(), self.weight.cpu().numpy(), self.origin.copy(),
                self.voxel_size)


def _offsets(splat_radius: int, device) -> torch.Tensor:
    r = range(-splat_radius, splat_radius + 1)
    return torch.tensor([(dx, dy, dz) for dx in r for dy in r for dz in r],
                        dtype=torch.int64, device=device)  # (K, 3)


def _fuse(points: torch.Tensor, normals: torch.Tensor, origin: torch.Tensor,
          voxel_size: float, grid_shape: Tuple[int, int, int], splat_radius: int,
          chunk: int = FUSE_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked splat of every point over the (2r+1)^3 offsets around its
    voxel: (sdf, weight), each (X, Y, Z) float32 on the points' device.

    The arithmetic is the JAX package's in float32 (its voxel size is a
    traced float32 scalar there), so each contribution agrees to a few ulp;
    offsets outside the grid add weight 0 to a clipped id, as there.
    """
    device = points.device
    nx, ny, nz = grid_shape
    v = torch.tensor(voxel_size, dtype=torch.float32, device=device)
    inv_v = 1.0 / v
    sigma2 = (v * splat_radius) ** 2
    offs = _offsets(splat_radius, device)
    dims = torch.tensor(grid_shape, dtype=torch.int64, device=device)
    sdf_acc = torch.zeros(nx * ny * nz, dtype=torch.float32, device=device)
    w_acc = torch.zeros_like(sdf_acc)
    for s in range(0, points.shape[0], chunk):
        p = points[s:s + chunk]
        nrm = normals[s:s + chunk]
        base = torch.floor((p - origin) * inv_v).to(torch.int64)  # (C, 3)
        vox = base[:, None, :] + offs[None, :, :]  # (C, K, 3)
        in_grid = ((vox >= 0) & (vox < dims)).all(dim=-1)
        center = origin + (vox.to(torch.float32) + 0.5) * v
        d = center - p[:, None, :]
        plane_dist = (d * nrm[:, None, :]).sum(dim=-1)
        w = torch.exp(-(d * d).sum(dim=-1) / (2.0 * sigma2))
        w = torch.where(in_grid, w, torch.zeros_like(w))
        vc = torch.minimum(vox.clamp(min=0), dims - 1)
        flat = (vc[..., 0] * (ny * nz) + vc[..., 1] * nz + vc[..., 2]).reshape(-1)
        sdf_acc.index_add_(0, flat, (plane_dist * w).reshape(-1))
        w_acc.index_add_(0, flat, w.reshape(-1))
    sdf = torch.where(w_acc > 1e-12, sdf_acc / w_acc.clamp(min=1e-12),
                      torch.zeros_like(sdf_acc))
    return sdf.reshape(grid_shape), w_acc.reshape(grid_shape)


def _dim_bucket(d: int) -> int:
    """A grid dimension rounded up to {2, 3} * 2^j (at least 32), as the JAX
    package buckets it to share compiled programs.  The port keeps the
    bucketing because it fixes the grid's shape, and so the cube ids, that
    the two packages' meshes are compared by; the padding voxels carry
    zero weight."""
    v = 32
    while v < d:
        v = v * 3 // 2 if (v & (v - 1)) == 0 else v * 4 // 3
    return v


def fuse_point_normal_sdf(
    points: np.ndarray,
    normals: np.ndarray,
    voxel_size: float = 0.03,
    splat_radius: int = 2,
    padding_voxels: int = 3,
    *,
    device=None,
) -> SdfGrid:
    """Fuse an oriented point cloud into a truncated SDF grid on ``device``
    (None: the card).

    Parameters
    ----------
    voxel_size : grid resolution (reference config: configs/s3dis_config.yaml
        voxel 0.03; the reference's hard-coded call used 0.02).
    splat_radius : truncation radius in voxels around each point.
    """
    device = device_or_card(device)
    points = np.asarray(points, dtype=np.float32)
    normals = np.asarray(normals, dtype=np.float32)
    if len(points) == 0:
        raise ValueError("fuse_point_normal_sdf: empty point cloud.")
    norms = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(norms, 1e-12)

    lo = points.min(axis=0) - padding_voxels * voxel_size
    hi = points.max(axis=0) + padding_voxels * voxel_size
    grid_shape = tuple(
        _dim_bucket(max(int(x), 2))
        for x in np.ceil((hi - lo) / voxel_size).astype(int) + 1
    )
    origin = lo.astype(np.float32)
    sdf, weight = _fuse(
        torch.from_numpy(points).to(device),
        torch.from_numpy(normals).to(device),
        torch.from_numpy(origin).to(device),
        float(voxel_size),
        grid_shape,
        int(splat_radius),
    )
    return SdfGrid(sdf=sdf, weight=weight, origin=origin, voxel_size=float(voxel_size))


def imls_project_vertices(
    verts: np.ndarray,
    points: np.ndarray,
    normals: np.ndarray,
    radius: float,
    iters: int = 2,
    k: int = 8,
    *,
    device=None,
) -> np.ndarray:
    """MISE-analog vertex refinement: project mesh vertices onto the IMLS
    zero set of the input point+normal cloud.

    Each iteration evaluates ``s(v) = sum_i w_i (v - p_i) . n_i / sum_i w_i``
    over the k nearest input points (Gaussian weights at ``radius``) and
    moves the vertex by ``-s`` along the averaged normal, the step clamped to
    ``radius``.  The k-NN runs on ``device`` (None: the card): the exact
    join up to ``exact_pair_budget`` pairs, above it the grid-hashed k-NN
    with room-invariant cells of 2 * radius, as in the JAX package; the
    projection itself is host numpy, as there.
    """
    from ipcgen_tpu_torch.ops.knn import exact_pair_budget, knn

    device = device_or_card(device)
    v = np.array(verts, np.float32, copy=True)
    points = np.asarray(points, np.float32)
    normals = np.asarray(normals, np.float32)
    if len(v) == 0 or len(points) == 0 or iters <= 0:
        return v

    if len(v) * len(points) > exact_pair_budget(device=device):
        from ipcgen_tpu_torch.ops.grid_nn import knn_grid

        def _knn(q, r, k):
            return knn_grid(q, r, k, cell_size=2.0 * radius, device=device)
    else:
        def _knn(q, r, k):
            return knn(q, r, k, device=device)

    for _ in range(int(iters)):
        idx, dist = _knn(v, points, k)
        unresolved = ~np.isfinite(dist[:, 0])
        if unresolved.any():  # sparse neighbourhoods: leave those in place
            idx = idx.copy()
            dist = dist.copy()
            idx[unresolved] = 0
            dist[unresolved] = 1e6  # zero weight below
        p = points[idx]  # (N, k, 3)
        nn = normals[idx]
        w = np.exp(-((dist / max(radius, 1e-6)) ** 2)).astype(np.float32)
        wsum = np.maximum(w.sum(axis=1), 1e-12)
        s = (w * np.einsum("nkj,nkj->nk", v[:, None, :] - p, nn)).sum(1) / wsum
        n_avg = (w[..., None] * nn).sum(axis=1)
        norm = np.linalg.norm(n_avg, axis=1)
        ok = norm > 1e-6
        n_avg[ok] /= norm[ok, None]
        step = np.clip(s, -radius, radius)
        v[ok] -= step[ok, None] * n_avg[ok]
    return v
