"""Device-resident scene acceleration structure.

Port of ``ipcgen_tpu/ops/scene_asset.py`` (:31-265): Morton-sorted
128-triangle leaf blocks padded with far-away degenerate triangles, NaN
AABBs for fully padded blocks, super-block AABBs, the block-count bucketing;
the result holds torch tensors on ``device``.

``build_scene_arrays`` is the JAX build's host numpy, array for array, and
the reference of the two routes of ``build_scene_asset``, which upload only
the float32 vertices and int32 triangles and build on the target device: a
CUDA device takes the hand-written kernels of ``csrc/scene_asset.cu``
(``scene_arrays_card``), any other the plain torch version
(``scene_arrays_plain``).  Both give ``build_scene_arrays``' arrays bit for
bit, so parity tests can also carry a JAX asset over with
``scene_asset_from_numpy``.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ipcgen_tpu_torch.utils.device import upload

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


def _mesh_tensors(vertices, triangles, device: torch.device):
    """The mesh as the routes take it: float32 vertices (cast from the input
    as ``build_scene_arrays`` casts them) and int32 triangles, checked and
    copied to ``device`` without waiting on its stream."""
    vertices = np.ascontiguousarray(vertices, dtype=np.float32).reshape(-1, 3)
    triangles = np.asarray(triangles).reshape(-1, 3)
    if len(triangles) == 0:
        raise ValueError("build_scene_asset: mesh has no triangles.")
    lo, hi = triangles.min(), triangles.max()
    if lo < 0 or hi >= len(vertices):
        raise ValueError(f"build_scene_asset: triangle indices span [{lo}, {hi}], "
                         f"outside [0, {len(vertices)})")
    return upload(vertices, device), upload(np.asarray(triangles, dtype=np.int32), device)


def _block_counts(n_tris: int, block_size: int, super_factor: int, bucket: bool):
    n_blocks = -(-n_tris // block_size)
    if bucket:
        n_blocks = _bucket_count(n_blocks)
    return n_blocks, -(-n_blocks // super_factor)


def scene_arrays_plain(vertices: torch.Tensor, triangles: torch.Tensor,
                       block_size: int = 128, super_factor: int = 8,
                       morton_bits: int = 10, bucket: bool = True) -> dict:
    """The asset's arrays in plain torch on the tensors' device, bit for bit
    those of ``build_scene_arrays`` (with its native Morton sort), plus
    ``n_tris``/``block_size``/``super_factor``.

    vertices (V, 3) float32 and triangles (T, 3) int32 with every index in
    [0, V), T > 0.  Every difference, product, sum, quotient and square root
    is its own torch op, rounded on its own as numpy's are (the square root
    through float64), and every scalar is a float32 tensor on the device (a
    CUDA division by a host scalar multiplies by its reciprocal); the Morton
    codes follow ``native/ipcgen_native.cc`` ``morton_order`` and sort
    stably.
    """
    dev = vertices.device

    def f32(x) -> torch.Tensor:
        return torch.tensor(np.float32(x), device=dev)

    n_tris = int(triangles.shape[0])
    corners = vertices[triangles.long()]  # (T, 3, 3)
    centroids = (corners[:, 0] + corners[:, 1] + corners[:, 2]) / f32(3.0)
    lo = centroids.amin(0)
    extent = torch.maximum(centroids.amax(0) - lo, f32(1e-9))
    inv = torch.ones_like(extent) / extent
    scale = (1 << morton_bits) - 1
    q = (((centroids - lo) * inv).clamp(0.0, 1.0) * f32(scale)).long().clamp(max=scale)

    def spread(v):
        v = v & ((1 << morton_bits) - 1)
        for shift, mask in ((32, 0x1F00000000FFFF), (16, 0x1F0000FF0000FF),
                            (8, 0x100F00F00F00F00F), (4, 0x10C30C30C30C30C3),
                            (2, 0x1249249249249249)):
            v = (v | (v << shift)) & mask
        return v

    codes = spread(q[:, 0]) | (spread(q[:, 1]) << 1) | (spread(q[:, 2]) << 2)
    order = torch.sort(codes, stable=True).indices
    corners = corners[order]
    tri_index = order.to(torch.int32)

    n_blocks, n_supers = _block_counts(n_tris, block_size, super_factor, bucket)
    n_pad = n_blocks * block_size - n_tris
    if n_pad:
        corners = torch.cat([corners, torch.full((n_pad, 3, 3), _PAD_COORD,
                                                 dtype=torch.float32, device=dev)])
        tri_index = torch.cat([tri_index, torch.full((n_pad,), -1, dtype=torch.int32,
                                                     device=dev)])
    v0 = corners[:, 0]
    e1 = corners[:, 1] - corners[:, 0]
    e2 = corners[:, 2] - corners[:, 0]
    tri_data = torch.zeros((n_blocks, 16, block_size), dtype=torch.float32, device=dev)
    tri_data[:, :9, :] = torch.cat([v0, e1, e2], 1).reshape(
        n_blocks, block_size, 9).transpose(1, 2)
    # numpy's cross: a1 b2 - a2 b1, a2 b0 - a0 b2, a0 b1 - a1 b0.
    raw = torch.stack([e1[:, i] * e2[:, j] - e1[:, j] * e2[:, i]
                       for i, j in ((1, 2), (2, 0), (0, 1))], 1)
    sq = raw * raw
    # numpy's (x x + y y) + z z.  torch's float32 square root on the CPU is
    # not always correctly rounded; the float64 root rounded to float32 is
    # (a float32's root lies at least 2^-51 of itself from a midpoint
    # between float32s, farther than a float64 root within an ulp strays).
    norm = torch.sqrt((sq[:, 0] + sq[:, 1] + sq[:, 2]).double()).float()
    tri_normal = raw / torch.maximum(norm, f32(1e-20))[:, None]
    tri_fin = torch.cat([tri_normal, tri_index.view(torch.float32)[:, None]], 1)

    # Leaf AABBs over real triangles only; NaN boxes for fully padded blocks.
    blk = corners.reshape(n_blocks, block_size, 3, 3)
    valid = (torch.arange(n_blocks * block_size, device=dev) < n_tris).reshape(
        n_blocks, block_size, 1, 1)
    inf = f32(np.inf)
    eps = f32(1e-5) * torch.maximum(extent.amax(), f32(1.0))
    blk_lo = torch.where(valid, blk, inf).amin((1, 2)) - eps
    blk_hi = torch.where(valid, blk, -inf).amax((1, 2)) + eps
    empty = ~torch.isfinite(blk_lo[:, :1])
    blk_lo = torch.where(empty, f32(np.nan), blk_lo)
    blk_hi = torch.where(empty, f32(np.nan), blk_hi)

    def nan_reduce(x, fill, reduce):
        x = torch.cat([x, torch.full((n_supers * super_factor - n_blocks, 3), np.nan,
                                     dtype=torch.float32, device=dev)])
        x = x.reshape(n_supers, super_factor, 3)
        nan = torch.isnan(x)
        out = reduce(torch.where(nan, f32(fill), x))
        return torch.where(nan.all(1), f32(np.nan), out)

    return dict(
        tri_data=tri_data,
        block_lo=blk_lo,
        block_hi=blk_hi,
        super_lo=nan_reduce(blk_lo, np.inf, lambda x: x.amin(1)),
        super_hi=nan_reduce(blk_hi, -np.inf, lambda x: x.amax(1)),
        tri_index=tri_index,
        tri_normal=tri_normal,
        tri_fin=tri_fin,
        n_tris=n_tris,
        block_size=block_size,
        super_factor=super_factor,
    )


def scene_arrays_card(vertices: torch.Tensor, triangles: torch.Tensor,
                      block_size: int = 128, super_factor: int = 8,
                      morton_bits: int = 10, bucket: bool = True) -> dict:
    """``scene_arrays_plain`` on a CUDA device through the kernels of
    ``csrc/scene_asset.cu``: the centroids and Morton codes
    (``_kernels.scene_codes_cuda``), ``torch.sort(stable=True)``, then the
    pack (``_kernels.scene_pack_cuda``).  Nothing is read back to the host;
    the arrays are the plain version's bit for bit."""
    from ipcgen_tpu_torch.ops import _kernels

    n_tris = int(triangles.shape[0])
    codes, keys = _kernels.scene_codes_cuda(vertices, triangles, morton_bits)
    order = torch.sort(codes, stable=True).indices
    n_blocks, _ = _block_counts(n_tris, block_size, super_factor, bucket)
    out = _kernels.scene_pack_cuda(vertices, triangles, order, keys, n_blocks,
                                   block_size, super_factor)
    return dict(out, n_tris=n_tris, block_size=block_size, super_factor=super_factor)


def builds_on_card(device) -> bool:
    """Whether ``build_scene_asset`` builds on ``device`` with the kernels."""
    return torch.device(device).type == "cuda"


def build_scene_asset(vertices, triangles, block_size: int = 128,
                      super_factor: int = 8, morton_bits: int = 10,
                      bucket: bool = True, device="cuda") -> SceneAsset:
    """Upload the mesh (float32 vertices, int32 triangles) and build the
    two-level structure on ``device``: with the kernels on a CUDA device
    (``scene_arrays_card``), with the plain torch version elsewhere
    (``scene_arrays_plain``).  The arrays are ``build_scene_arrays``'."""
    device = torch.device(device)
    verts, tris = _mesh_tensors(vertices, triangles, device)
    build = scene_arrays_card if builds_on_card(device) else scene_arrays_plain
    fields = build(verts, tris, block_size, super_factor, morton_bits, bucket)
    return SceneAsset(**fields)


def asset_from_mesh(mesh, block_size: int = 128, super_factor: int = 8, *,
                    device=None) -> SceneAsset:
    """The asset of a ``TriMesh``-like object (vertices, triangles) on
    ``device`` (None: the card)."""
    return build_scene_asset(
        np.asarray(mesh.vertices), np.asarray(mesh.triangles), block_size,
        super_factor, device="cuda" if device is None else device,
    )
