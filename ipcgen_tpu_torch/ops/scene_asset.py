"""Device-resident scene acceleration structure.

Port of ``ipcgen_tpu/ops/scene_asset.py`` (:31-265).  The build is the same
host numpy (Morton-sorted 128-triangle leaf blocks padded with far-away
degenerate triangles, NaN AABBs for fully padded blocks, super-block AABBs,
the block-count bucketing); the result holds torch tensors on ``device``.
The arrays are identical to the JAX build's, so parity tests can also carry
a JAX asset over with ``scene_asset_from_numpy``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

# A padded triangle parked far outside any scene so it can never be hit.
_PAD_COORD = 1e7

_ARRAY_FIELDS = (
    "tri_data", "block_lo", "block_hi", "super_lo", "super_hi",
    "tri_index", "tri_normal", "tri_fin",
)


def morton3d(ix: np.ndarray, iy: np.ndarray, iz: np.ndarray, bits: int = 10) -> np.ndarray:
    """Interleave three ``bits``-bit integer grids into Morton codes (vectorized)."""

    def spread(v: np.ndarray) -> np.ndarray:
        v = v.astype(np.uint64) & np.uint64((1 << bits) - 1)
        v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
        v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
        v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
        v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
        v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
        return v

    return spread(ix) | (spread(iy) << np.uint64(1)) | (spread(iz) << np.uint64(2))


@dataclass
class SceneAsset:
    """Device-resident triangle scene.

    tri_data   (NB, 16, TB) float32: rows 0..8 = v0, e1, e2 components,
               rows 9..15 zero; lanes are the block's TB triangles.
    block_lo / block_hi (NB, 3) float32 leaf AABBs (NaN for padded blocks).
    super_lo / super_hi (NS, 3) float32 super-block AABBs.
    tri_index  (NB*TB,) int32 original triangle id per packed slot, -1 pad.
    tri_normal (NB*TB, 3) float32 unit geometric normals.
    tri_fin    (NB*TB, 4) float32 [normal xyz, bitcast(tri_index)].
    """

    tri_data: torch.Tensor
    block_lo: torch.Tensor
    block_hi: torch.Tensor
    super_lo: torch.Tensor
    super_hi: torch.Tensor
    tri_index: torch.Tensor
    tri_normal: torch.Tensor
    tri_fin: torch.Tensor
    n_tris: int
    block_size: int
    super_factor: int

    @property
    def device(self) -> torch.device:
        return self.tri_data.device

    @property
    def num_blocks(self) -> int:
        return self.tri_data.shape[0]

    @property
    def num_supers(self) -> int:
        return self.super_lo.shape[0]

    def to(self, device) -> "SceneAsset":
        """The same asset with its tensors on ``device``."""
        moved = {k: getattr(self, k).to(device) for k in _ARRAY_FIELDS}
        return SceneAsset(**moved, n_tris=self.n_tris, block_size=self.block_size,
                          super_factor=self.super_factor)


def _bucket_count(n: int, granularity: int = 4) -> int:
    """Round up to the next (granularity..2*granularity-1) * 2^j bucket
    (kept so the block count, and with it the packed slots, equal the JAX
    build's)."""
    if n <= granularity:
        return n
    j = (n - 1).bit_length() - granularity.bit_length() + 1
    step = 1 << max(j, 0)
    return -(-n // step) * step


def build_scene_arrays(
    vertices: np.ndarray,
    triangles: np.ndarray,
    block_size: int = 128,
    super_factor: int = 8,
    morton_bits: int = 10,
    bucket: bool = True,
) -> dict:
    """The asset's arrays as numpy, plus ``n_tris``/``block_size``/
    ``super_factor`` (the host half of ``build_scene_asset``)."""
    vertices = np.asarray(vertices, dtype=np.float32)
    triangles = np.asarray(triangles, dtype=np.int64).reshape(-1, 3)
    n_tris = len(triangles)
    if n_tris == 0:
        raise ValueError("build_scene_asset: mesh has no triangles.")

    corners = vertices[triangles]  # (T, 3, 3)
    centroids = corners.mean(axis=1)

    from ipcgen_tpu_torch.utils import native

    order = native.morton_order(centroids, bits=morton_bits)
    lo = centroids.min(axis=0)
    hi = centroids.max(axis=0)
    extent = np.maximum(hi - lo, 1e-9)
    if order is None:
        scale = (1 << morton_bits) - 1
        q = np.clip(((centroids - lo) / extent * scale), 0, scale).astype(np.uint64)
        codes = morton3d(q[:, 0], q[:, 1], q[:, 2], bits=morton_bits)
        order = np.argsort(codes, kind="stable")

    corners = corners[order]
    tri_index = order.astype(np.int32)

    n_blocks = -(-n_tris // block_size)
    if bucket:
        n_blocks = _bucket_count(n_blocks)
    n_pad = n_blocks * block_size - n_tris
    if n_pad:
        pad_tri = np.full((n_pad, 3, 3), _PAD_COORD, dtype=np.float32)
        corners = np.concatenate([corners, pad_tri], axis=0)
        tri_index = np.concatenate([tri_index, np.full(n_pad, -1, np.int32)])

    v0 = corners[:, 0]
    e1 = corners[:, 1] - corners[:, 0]
    e2 = corners[:, 2] - corners[:, 0]
    packed = np.concatenate([v0, e1, e2], axis=1).reshape(n_blocks, block_size, 9)
    tri_data = np.zeros((n_blocks, 16, block_size), dtype=np.float32)
    tri_data[:, :9, :] = packed.transpose(0, 2, 1)

    raw_n = np.cross(e1, e2)
    norm = np.linalg.norm(raw_n, axis=1, keepdims=True)
    tri_normal = (raw_n / np.maximum(norm, 1e-20)).astype(np.float32)
    tri_fin = np.concatenate(
        [tri_normal, tri_index.view(np.float32)[:, None]], axis=1
    )

    # Leaf AABBs over real triangles only; fully padded blocks get NaN boxes
    # (NaN comparisons are false -> the slab test can never pass).
    blk_corners = corners.reshape(n_blocks, block_size, 3, 3)
    valid = (
        np.arange(n_blocks * block_size).reshape(n_blocks, block_size) < n_tris
    )[..., None, None]
    blk_lo = np.where(valid, blk_corners, np.inf).min(axis=(1, 2))
    blk_hi = np.where(valid, blk_corners, -np.inf).max(axis=(1, 2))
    eps = 1e-5 * np.maximum(extent.max(), 1.0)
    blk_lo -= eps
    blk_hi += eps
    empty_blocks = ~np.isfinite(blk_lo[:, 0])
    blk_lo[empty_blocks] = np.nan
    blk_hi[empty_blocks] = np.nan

    n_supers = -(-n_blocks // super_factor)
    pad_blocks = n_supers * super_factor - n_blocks
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", category=RuntimeWarning)
        sup_lo = np.nanmin(
            np.concatenate(
                [blk_lo, np.full((pad_blocks, 3), np.nan, np.float32)], axis=0
            ).reshape(n_supers, super_factor, 3),
            axis=1,
        )
        sup_hi = np.nanmax(
            np.concatenate(
                [blk_hi, np.full((pad_blocks, 3), np.nan, np.float32)], axis=0
            ).reshape(n_supers, super_factor, 3),
            axis=1,
        )

    return dict(
        tri_data=tri_data,
        block_lo=blk_lo.astype(np.float32),
        block_hi=blk_hi.astype(np.float32),
        super_lo=sup_lo.astype(np.float32),
        super_hi=sup_hi.astype(np.float32),
        tri_index=tri_index,
        tri_normal=tri_normal,
        tri_fin=tri_fin,
        n_tris=n_tris,
        block_size=block_size,
        super_factor=super_factor,
    )


def scene_asset_from_numpy(fields: Mapping, device) -> SceneAsset:
    """Asset on ``device`` from numpy arrays keyed by field name (for example
    the arrays of a JAX ``SceneAsset`` after ``np.asarray``) plus
    ``n_tris``/``block_size``/``super_factor``."""
    tensors = {
        k: torch.from_numpy(np.array(fields[k], copy=True)).to(device)
        for k in _ARRAY_FIELDS
    }
    return SceneAsset(
        **tensors,
        n_tris=int(fields["n_tris"]),
        block_size=int(fields["block_size"]),
        super_factor=int(fields["super_factor"]),
    )


def build_scene_asset(vertices, triangles, block_size: int = 128,
                      super_factor: int = 8, morton_bits: int = 10,
                      bucket: bool = True, device="cuda") -> SceneAsset:
    """Build the two-level structure on the host and move it to ``device``."""
    return scene_asset_from_numpy(
        build_scene_arrays(vertices, triangles, block_size, super_factor,
                           morton_bits, bucket),
        device,
    )


def asset_from_mesh(mesh, block_size: int = 128, super_factor: int = 8, *,
                    device=None) -> SceneAsset:
    """The asset of a ``TriMesh``-like object (vertices, triangles) on
    ``device`` (None: the card)."""
    return build_scene_asset(
        np.asarray(mesh.vertices), np.asarray(mesh.triangles), block_size,
        super_factor, device="cuda" if device is None else device,
    )
