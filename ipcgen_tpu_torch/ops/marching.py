"""Isosurface extraction: marching tetrahedra over the fused SDF grid (port
of ``ipcgen_tpu/ops/marching.py``).

Each cube is split into 6 tetrahedra, whose 16-entry case table has no
ambiguous configuration and vectorises into a handful of gathers:

  pass 1: classify every cube (8 valid corners and mixed signs);
  pass 2: list the active cubes (``torch.nonzero``, on the grid's device);
  pass 3: per chunk of active cubes, interpolate the tet edges, gather the
          case table's triangles and keep the valid ones, in order.

Only the finished soup comes back to the host.  The JAX package pads each
chunk to a fixed length to share compiled programs; the port keeps the
chunking, which bounds memory, and drops the padding.  Vertex welding is
host numpy, as there.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ipcgen_tpu_torch.ops.sdf import SdfGrid

# Cube corner offsets, standard ordering
_CORNERS = np.array(
    [
        [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
        [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1],
    ],
    dtype=np.int32,
)

# 6-tetrahedra decomposition around the 0-6 diagonal
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 2, 6],
        [0, 2, 3, 6],
        [0, 3, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    dtype=np.int32,
)

# The 6 edges of a tetrahedron as (corner, corner) local indices
_TET_EDGES = np.array(
    [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.int32
)

# Case table: for each 4-bit inside mask, up to 2 triangles of tet-edge ids
# (-1 padding).  Winding is normalized numerically afterwards.
_TET_TRIS = -np.ones((16, 2, 3), dtype=np.int32)
_TET_TRIS[1, 0] = (0, 1, 2)          # a inside
_TET_TRIS[2, 0] = (0, 4, 3)          # b
_TET_TRIS[3] = [(1, 2, 4), (1, 4, 3)]  # a, b
_TET_TRIS[4, 0] = (1, 3, 5)          # c
_TET_TRIS[5] = [(0, 2, 5), (0, 5, 3)]  # a, c
_TET_TRIS[6] = [(0, 4, 5), (0, 5, 1)]  # b, c
_TET_TRIS[7, 0] = (2, 4, 5)          # a, b, c
_TET_TRIS[8, 0] = (2, 5, 4)          # d
_TET_TRIS[9] = [(0, 1, 5), (0, 5, 4)]  # a, d
_TET_TRIS[10] = [(0, 3, 5), (0, 5, 2)]  # b, d
_TET_TRIS[11, 0] = (1, 3, 5)         # a, b, d
_TET_TRIS[12] = [(1, 3, 4), (1, 4, 2)]  # c, d
_TET_TRIS[13, 0] = (0, 3, 4)         # a, c, d
_TET_TRIS[14, 0] = (0, 1, 2)         # b, c, d

# Active cubes per extraction chunk: a chunk holds (chunk, 12, 3, 3) floats.
MARCH_CHUNK = 65536


def _classify_cubes(sdf: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(X-1, Y-1, Z-1) bool: all 8 corners valid AND signs are mixed."""
    def corner(a, dx, dy, dz):
        return a[
            dx : a.shape[0] - 1 + dx,
            dy : a.shape[1] - 1 + dy,
            dz : a.shape[2] - 1 + dz,
        ]

    all_valid = None
    any_neg = None
    any_pos = None
    for dx, dy, dz in _CORNERS:
        v = corner(valid, dx, dy, dz)
        s = corner(sdf, dx, dy, dz)
        all_valid = v if all_valid is None else (all_valid & v)
        neg = s < 0
        any_neg = neg if any_neg is None else (any_neg | neg)
        any_pos = (~neg) if any_pos is None else (any_pos | (~neg))
    return all_valid & any_neg & any_pos


def _extract_active(
    sdf: torch.Tensor,
    cube_idx: torch.Tensor,  # (A, 3) int64 active cube coordinates
    origin: torch.Tensor,  # (3,) float32
    voxel_size: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Triangle soup for active cubes: (A, 12, 3, 3) vertices + (A, 12) mask.
    float32 throughout, as the JAX package (its voxel size is a float32
    scalar there)."""
    device = sdf.device
    corners = cube_idx[:, None, :] + torch.from_numpy(_CORNERS).to(device)[None]  # (A, 8, 3)
    vals = sdf[corners[..., 0], corners[..., 1], corners[..., 2]]  # (A, 8)
    v = torch.tensor(voxel_size, dtype=torch.float32, device=device)
    pos = origin + (corners.to(torch.float32) + 0.5) * v  # (A, 8, 3)
    tet_tris = torch.from_numpy(_TET_TRIS).to(device=device, dtype=torch.int64)  # (16, 2, 3)
    ea = torch.from_numpy(_TET_EDGES[:, 0]).to(device=device, dtype=torch.int64)
    eb = torch.from_numpy(_TET_EDGES[:, 1]).to(device=device, dtype=torch.int64)
    rows = torch.arange(cube_idx.shape[0], device=device)[:, None, None]

    tris_out = []
    mask_out = []
    for t in range(6):
        cidx = torch.from_numpy(_TETS[t]).to(device=device, dtype=torch.int64)
        tv = vals[:, cidx]  # (A, 4)
        tp = pos[:, cidx]  # (A, 4, 3)
        inside = (tv < 0).to(torch.int64)
        m = inside[:, 0] + 2 * inside[:, 1] + 4 * inside[:, 2] + 8 * inside[:, 3]  # (A,)
        # All 6 edge crossings (guarded)
        va = tv[:, ea]  # (A, 6)
        vb = tv[:, eb]
        denom = va - vb
        tt = torch.where(denom.abs() > 1e-12,
                         va / torch.where(denom == 0, torch.ones_like(denom), denom),
                         torch.full_like(denom, 0.5))
        tt = tt.clamp(0.0, 1.0)
        edge_pts = tp[:, ea] + tt[..., None] * (tp[:, eb] - tp[:, ea])  # (A, 6, 3)

        case = tet_tris[m]  # (A, 2, 3) edge ids (-1 pad)
        # The 3 edge vertices of each (up to 2) triangle per tet.
        tris_out.append(edge_pts[rows, case.clamp(min=0)])  # (A, 2, 3, 3)
        mask_out.append(case[:, :, 0] >= 0)  # (A, 2)

    return torch.cat(tris_out, dim=1), torch.cat(mask_out, dim=1)


def _compact_soup(tris: torch.Tensor, mask: torch.Tensor, ids: torch.Tensor):
    """The valid triangles, in order, with their cube ids: what the JAX
    package's stable "valid first" argsort puts in front."""
    flat_m = mask.reshape(-1)
    flat_i = ids.repeat_interleave(mask.shape[1])
    return tris.reshape(-1, 3, 3)[flat_m], flat_i[flat_m]


def marching_tetrahedra(grid: SdfGrid, min_weight: float = 1e-3,
                        chunk: int = MARCH_CHUNK) -> Tuple[np.ndarray, np.ndarray]:
    """Extract the zero isosurface as a triangle soup, on the grid's device.

    Returns
    -------
    triangles : (T, 3, 3) float32 corner positions.
    cube_ids : (T,) int32 flat cube id per emitted triangle.
    """
    sdf = grid.sdf
    ij = torch.nonzero(_classify_cubes(sdf, grid.valid(min_weight)))  # (A, 3), C order
    if ij.shape[0] == 0:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0,), np.int32)
    origin = torch.from_numpy(np.asarray(grid.origin, np.float32)).to(sdf.device)
    _, y, z = sdf.shape
    all_tris, all_ids = [], []
    for s in range(0, ij.shape[0], chunk):
        part = ij[s:s + chunk]
        tris, mask = _extract_active(sdf, part, origin, grid.voxel_size)
        flat_ids = part[:, 0] * ((y - 1) * (z - 1)) + part[:, 1] * (z - 1) + part[:, 2]
        tris_c, ids_c = _compact_soup(tris, mask, flat_ids)
        all_tris.append(tris_c)
        all_ids.append(ids_c)
    return (torch.cat(all_tris).cpu().numpy().astype(np.float32),
            torch.cat(all_ids).to(torch.int32).cpu().numpy())


def weld_triangle_soup(
    triangles: np.ndarray, decimals: int = 5
) -> Tuple[np.ndarray, np.ndarray]:
    """Merge duplicated soup vertices into an indexed mesh (host-side).

    Shared vertices from adjacent tetrahedra are bitwise identical (the edge
    interpolation sees the same corner values), so welding only has to group
    equal positions. Rounded coordinates are packed into one int64 key
    (21 bits/axis) — a scalar unique is ~40x faster than np.unique(axis=0)'s
    3-column lexsort at the ~1.4M-vertex scale of a room mesh.
    """
    if len(triangles) == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    flat = triangles.reshape(-1, 3)
    scale = 10.0 ** decimals
    q = np.round(flat * scale).astype(np.int64)
    offset = q.min(axis=0)
    q -= offset  # non-negative
    if np.any(q.max(axis=0) >= (1 << 21)):
        # Extent too large for packed keys at this tolerance: coarsen until
        # it fits (10^5 * 2^21 ≈ 21 km at the default, so this is theoretical).
        while np.any(q.max(axis=0) >= (1 << 21)):
            q >>= 1
    key = (q[:, 0] << 42) | (q[:, 1] << 21) | q[:, 2]
    uniq_keys, inverse = np.unique(key, return_inverse=True)
    # Mean of the original positions per welded vertex (usually identical)
    counts = np.bincount(inverse, minlength=len(uniq_keys))
    verts = np.stack(
        [
            np.bincount(inverse, weights=flat[:, a], minlength=len(uniq_keys))
            for a in range(3)
        ],
        axis=1,
    ) / counts[:, None]
    verts = verts.astype(np.float32)
    tris = inverse.reshape(-1, 3).astype(np.int32)
    # Drop degenerate triangles
    ok = (
        (tris[:, 0] != tris[:, 1])
        & (tris[:, 1] != tris[:, 2])
        & (tris[:, 0] != tris[:, 2])
    )
    return verts, tris[ok]
