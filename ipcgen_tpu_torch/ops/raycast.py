"""Ray/mesh intersection: the oracles, finalize, and the public dispatch.

Port of ``ipcgen_tpu/ops/raycast.py`` (:40-79 ``raycast_brute``, :82-113
``_raycast_asset_xla_core`` as ``raycast_block_scan``, :261-279
``finalize_result``, :282-287 ``raycast_asset_xla`` and :336-351 as
``raycast_asset_brute``, :290-351 ``raycast_asset``).  ``raycast_asset``
casts through the backends of ``ops/raycast_backends.py``: ``"pairs"`` (the
default), ``"culled"``, bit-exact against ``"brute"``, and ``"brute"``, the
JAX package's ``xla_brute`` oracle, a scan over every leaf block in the
component form of Moller-Trumbore (``raycast_block_scan``), with hits at or
beyond ``t_max`` dropped afterwards.

There is no "auto" backend that picks a slower path off the accelerator: the
device of the tensors decides, and a CUDA tensor goes to the kernel; any
device but the CPU and CUDA raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ipcgen_tpu_torch.ops.geometry import moller_trumbore, moller_trumbore_components
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset


class RaycastResult(NamedTuple):
    """Fixed-shape raycast output (mask instead of compaction)."""

    t: torch.Tensor  # (R,) float32, +inf on miss
    tri_id: torch.Tensor  # (R,) int32 original triangle id, -1 on miss
    hit: torch.Tensor  # (R,) bool
    points: torch.Tensor  # (R, 3) float32, 0 where miss
    normals: torch.Tensor  # (R, 3) float32 unit geometric normals, 0 where miss


def raycast_brute(origins, dirs, v0, e1, e2, chunk: int = 512,
                  max_elems: int = 1 << 22):
    """Moller-Trumbore of every ray against every triangle, in the vector
    (sum) form of JAX ``raycast_brute``; the ``"brute"`` backend runs
    ``raycast_block_scan`` instead.

    Chunked over triangles (``chunk`` per step, first minimum within a chunk,
    strict ``<`` across chunks: ties go to the smallest triangle index) and
    over rays so each (rays, chunk) step holds at most ``max_elems`` pairs.
    Returns (t (R,) +inf on miss, idx (R,) int32 into the input order, -1 on
    miss).
    """
    origins = origins.float()
    dirs = dirs.float()
    n_rays = origins.shape[0]
    n_tris = v0.shape[0]
    dev = origins.device
    best_t = torch.full((n_rays,), float("inf"), device=dev)
    best_i = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    ray_chunk = max(1, max_elems // chunk)
    for r0 in range(0, n_rays, ray_chunk):
        o = origins[r0:r0 + ray_chunk, None, :]
        d = dirs[r0:r0 + ray_chunk, None, :]
        bt = best_t[r0:r0 + ray_chunk]
        bi = best_i[r0:r0 + ray_chunk]
        for c0 in range(0, n_tris, chunk):
            t = moller_trumbore(
                o, d, v0[None, c0:c0 + chunk], e1[None, c0:c0 + chunk],
                e2[None, c0:c0 + chunk],
            )  # (rays, chunk)
            tmin, targ = torch.min(t, dim=1)
            take = tmin < bt
            bt.copy_(torch.where(take, tmin, bt))
            bi.copy_(torch.where(take, targ.int() + c0, bi))
    best_i = torch.where(torch.isfinite(best_t), best_i,
                         torch.full_like(best_i, -1))
    return best_t, best_i


def finalize_result(origins, dirs, t, packed_slot, asset: SceneAsset) -> RaycastResult:
    """Map packed slots to original ids, gather normals, compute hit points,
    with ONE (R, 4) gather from the packed ``tri_fin`` table."""
    hit = torch.isfinite(t) & (packed_slot >= 0)
    slot = torch.clamp(packed_slot, min=0).long()
    fin = asset.tri_fin[slot]  # (R, 4): [normal xyz, bitcast(tri_index)]
    tri_id = torch.where(
        hit, fin[:, 3].contiguous().view(torch.int32),
        torch.full_like(packed_slot, -1, dtype=torch.int32),
    )
    zero3 = torch.zeros_like(fin[:, :3])
    normals = torch.where(hit[:, None], fin[:, :3], zero3)
    t_safe = torch.where(hit, t, torch.zeros_like(t))
    points = torch.where(hit[:, None], origins + dirs * t_safe[:, None], zero3)
    return RaycastResult(t=t, tri_id=tri_id, hit=hit, points=points.float(),
                         normals=normals)


def raycast_block_scan(origins, dirs, tri_data, max_elems: int = 1 << 22):
    """Moller-Trumbore (component form) of every ray against every leaf
    block, block by block in ascending order: the first minimum within a
    block, then strict ``<`` across blocks, so ties go to the smallest
    packed slot.  Rays are taken in chunks of ``max_elems // TB``.

    Returns (t (R,) +inf on miss, packed slot (R,) int32, -1 on miss).
    """
    origins = origins.float()
    dirs = dirs.float()
    nb, _, tb = tri_data.shape
    n = origins.shape[0]
    best_t = torch.full((n,), float("inf"), device=origins.device)
    best_i = torch.full((n,), -1, dtype=torch.int32, device=origins.device)
    ray_chunk = max(1, max_elems // tb)
    for r0 in range(0, n, ray_chunk):
        o = origins[r0:r0 + ray_chunk, :, None]  # (rays, 3, 1)
        d = dirs[r0:r0 + ray_chunk, :, None]
        bt = best_t[r0:r0 + ray_chunk]
        bi = best_i[r0:r0 + ray_chunk]
        for b in range(nb):
            blk = tri_data[b]  # (16, TB) component panel
            t = moller_trumbore_components(
                o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                *(blk[k][None, :] for k in range(9)),
            )  # (rays, TB)
            tmin, targ = torch.min(t, dim=1)
            take = tmin < bt
            bt.copy_(torch.where(take, tmin, bt))
            bi.copy_(torch.where(take, targ.int() + b * tb, bi))
    return best_t, best_i


def raycast_brute_components(origins, dirs, tri_data, t_max: float = np.inf,
                             max_elems: int = 1 << 22):
    """The oracle (JAX ``xla_brute``) as (t, packed slot): the block scan,
    with hits at or beyond ``t_max`` dropped afterwards."""
    t, slot = raycast_block_scan(origins, dirs, tri_data, max_elems=max_elems)
    if np.isfinite(t_max):
        keep = t < t_max
        t = torch.where(keep, t, torch.full_like(t, float("inf")))
        slot = torch.where(keep, slot, torch.full_like(slot, -1))
    return t, slot


def raycast_asset_brute(origins, dirs, asset: SceneAsset,
                        t_max: float = np.inf) -> RaycastResult:
    """The oracle over the resident asset, finalized (with ``t_max`` left
    infinite, JAX ``raycast_asset_xla``)."""
    origins = origins.float()
    dirs = dirs.float()
    t, slot = raycast_brute_components(origins, dirs, asset.tri_data, t_max)
    return finalize_result(origins, dirs, t, slot, asset)


def raycast_asset(origins, dirs, asset: SceneAsset, backend: str = "pairs",
                  t_max: float = np.inf, sort_rays="auto") -> RaycastResult:
    """Intersect (R, 3) rays with the resident scene.

    ``backend`` is ``"pairs"`` or ``"culled"`` (CUDA kernel for CUDA
    tensors, its plain version for CPU tensors) or ``"brute"`` (the
    oracle); ``ops.raycast_backends.lookup`` raises on any other name.
    ``t_max`` caps the hit distance (strictly below).
    ``sort_rays`` (pairs only: "auto", True or False) regroups incoherent
    rays into coherent tiles first; "auto" does so when more than 2 % of
    tiles overflow their candidate lists.
    """
    from ipcgen_tpu_torch.ops.raycast_backends import lookup  # it imports this module

    cast = lookup(backend).cast_asset
    origins = torch.as_tensor(origins, dtype=torch.float32,
                              device=asset.device)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=asset.device)
    return cast(origins, dirs, asset, t_max, sort_rays)
