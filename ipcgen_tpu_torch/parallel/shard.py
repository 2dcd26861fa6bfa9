"""Sharded multi-device raycast paths over ``torch.distributed`` (port of
``ipcgen_tpu/parallel/shard.py``).

- Rays sharded (``sharded_raycast_rays``): every rank casts its slice of the
  rays against the whole scene asset, then ``all_gather`` assembles them.
- Triangles sharded (``sharded_raycast_tris``): the leaf blocks are cut into
  whole super blocks, one slice a rank; every rank casts all rays against
  its slice, makes its packed slots global, and an ``all_gather`` plus a
  min-t combine picks each ray's nearest hit.
- Both (``sharded_raycast_2d``) over a 2-D mesh ``("rays", "tris")``.
- ``scan_waypoints_sharded``: the fused scan of ``sim/scan.py`` with its
  raycast ray-sharded; ``sharded_grid_nn``: the label transfer's 1-NN with
  the queries sharded.

The per-shard pieces (``shard_asset_blocks``, ``block_shard``,
``local_raycast``, ``globalize_slots``, ``combine_nearest``) are plain
functions, so one process can run S shards in turn: one card holds one
NCCL rank.

Ties: the combine takes the first minimum over the shards, and shards are in
slot order, so a tie goes to the smallest global slot, the kernels' own rule.
The culled and brute backends compute each ray-triangle test alone, so their
sharded results equal the unsharded ones bit for bit.  The pair kernel
centres its panels on the scene it is given, so a triangle shard's tests
round otherwise and that path is held to the raycast contract.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ipcgen_tpu_torch.ops.raycast import RaycastResult, finalize_result
from ipcgen_tpu_torch.ops.raycast_backends import lookup, resolve_backend
from ipcgen_tpu_torch.ops.raycast_pairs import _nanmax, _nanmin
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset


def make_device_mesh(n_devices: Optional[int] = None,
                     axis_names: Tuple[str, ...] = ("rays",)):
    """A ``DeviceMesh`` over the initialised default process group: 1-D, or
    with two axis names a near-square 2-D factoring (the first axis the
    larger).  Its device type follows the backend: "cuda" for NCCL, "cpu"
    for gloo.  ``n_devices`` must be the world size (every rank takes part
    in every collective)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_device_mesh needs an initialised process group")
    world = dist.get_world_size()
    n_devices = world if n_devices is None else int(n_devices)
    if n_devices != world:
        raise ValueError(f"a mesh spans the whole group: n_devices={n_devices}, "
                         f"world size {world}")
    if len(axis_names) == 1:
        shape = (n_devices,)
    else:
        a = int(np.floor(np.sqrt(n_devices)))
        while n_devices % a:
            a -= 1
        shape = (n_devices // a, a)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))


def _axis(mesh, axis: str) -> Tuple[int, int]:
    """(shards along ``axis``, this rank's index along it)."""
    return mesh.shape[mesh.mesh_dim_names.index(axis)], mesh.get_local_rank(axis)


def _all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """(S, ...) stack of every rank's ``x`` along ``axis``, in index order."""
    n, _ = _axis(mesh, axis)
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x.contiguous(), group=mesh.get_group(axis))
    return torch.stack(out)


def pad_rays(origins: torch.Tensor, dirs: torch.Tensor, multiple: int):
    """Rays padded to a multiple of ``multiple`` with rays far outside the
    scene pointing up; returns (origins, dirs, original count)."""
    n = origins.shape[0]
    pad = (-n) % multiple
    if pad:
        origins = torch.cat([origins, origins.new_full((pad, 3), 1e8)])
        dirs = torch.cat([dirs, dirs.new_tensor([[0.0, 0.0, 1.0]]).expand(pad, 3)])
    return origins, dirs, n


def ray_shard(origins: torch.Tensor, dirs: torch.Tensor, n_shards: int, index: int):
    """Shard ``index`` of ``n_shards`` contiguous slices of the padded rays."""
    origins, dirs, _ = pad_rays(origins, dirs, n_shards)
    per = origins.shape[0] // n_shards
    return origins[index * per:(index + 1) * per], dirs[index * per:(index + 1) * per]


def shard_asset_blocks(asset: SceneAsset, n_shards: int) -> SceneAsset:
    """The asset with its leaf blocks padded to a multiple of ``n_shards *
    super_factor``, so each shard owns whole super blocks, and the super
    boxes rebuilt over the padded blocks.  Padded blocks hold far-away
    triangles and NaN boxes; a super's box ignores NaN (``_nanmin``), and an
    all-NaN super stays NaN, which no slab test passes."""
    nb, tb, sf = asset.num_blocks, asset.block_size, asset.super_factor
    pad = (-nb) % (n_shards * sf)
    if not pad:
        return asset
    dev = asset.device
    nanpad = torch.full((pad, 3), float("nan"), device=dev)
    block_lo = torch.cat([asset.block_lo, nanpad])
    block_hi = torch.cat([asset.block_hi, nanpad])
    tri_index = torch.cat([asset.tri_index,
                           torch.full((pad * tb,), -1, dtype=torch.int32, device=dev)])
    tri_normal = torch.cat([asset.tri_normal, torch.zeros((pad * tb, 3), device=dev)])
    ns = (nb + pad) // sf
    return SceneAsset(
        tri_data=torch.cat([asset.tri_data,
                            torch.full((pad, 16, tb), 1e7, device=dev)]),
        block_lo=block_lo,
        block_hi=block_hi,
        super_lo=_nanmin(block_lo.view(ns, sf, 3), 1),
        super_hi=_nanmax(block_hi.view(ns, sf, 3), 1),
        tri_index=tri_index,
        tri_normal=tri_normal,
        tri_fin=torch.cat([tri_normal, tri_index.view(torch.float32)[:, None]], dim=1),
        n_tris=asset.n_tris,
        block_size=tb,
        super_factor=sf,
    )


def block_shard(asset_p: SceneAsset, n_shards: int, index: int):
    """Shard ``index`` of an asset from ``shard_asset_blocks``: its (tri_data,
    block_lo, block_hi, super_lo, super_hi) slices."""
    nb = asset_p.num_blocks // n_shards
    ns = nb // asset_p.super_factor
    b, s = slice(index * nb, (index + 1) * nb), slice(index * ns, (index + 1) * ns)
    return (asset_p.tri_data[b], asset_p.block_lo[b], asset_p.block_hi[b],
            asset_p.super_lo[s], asset_p.super_hi[s])


def local_raycast(o, d, tri_data, block_lo, block_hi, super_lo, super_hi, *,
                  super_factor: int, t_max: float, backend: str):
    """One shard's raycast, (t, packed slot local to the shard), through the
    component call of the port's ``backend`` (``ops.raycast_backends``; the
    pair kernel without a ray sort: a shard keeps its rays' order); kernels
    for CUDA tensors, their plain versions for CPU tensors."""
    return lookup(backend).cast_parts(o, d, tri_data, block_lo, block_hi, super_lo,
                                      super_hi, super_factor=super_factor, t_max=t_max)


def globalize_slots(slot: torch.Tensor, index: int, shard_blocks: int,
                    block_size: int) -> torch.Tensor:
    """Shard ``index``'s packed slots as slots of the whole (padded) asset;
    -1 (a miss) stays -1."""
    return torch.where(slot >= 0, slot + index * shard_blocks * block_size, slot)


def combine_nearest(t_all: torch.Tensor, slot_all: torch.Tensor):
    """Each ray's nearest hit over (S, R) shard results: the first minimum
    of t over the shards (``argmin`` returns the first), hence the smallest
    global slot on a tie."""
    winner = torch.argmin(t_all, dim=0, keepdim=True)
    return t_all.gather(0, winner)[0], slot_all.gather(0, winner)[0]


def _sharded_cast(origins, dirs, asset: SceneAsset, mesh, ray_axis: Optional[str],
                  tri_axis: Optional[str], backend: str, t_max: float) -> RaycastResult:
    """Rays sharded over ``ray_axis``, blocks over ``tri_axis`` (either may be
    None); every rank returns the whole result."""
    origins = torch.as_tensor(origins, dtype=torch.float32, device=asset.device)
    dirs = torch.as_tensor(dirs, dtype=torch.float32, device=asset.device)
    backend = resolve_backend(backend)
    n = origins.shape[0]
    o, d = origins, dirs
    if ray_axis is not None:
        o, d = ray_shard(origins, dirs, *_axis(mesh, ray_axis))
    asset_p = asset
    parts = (asset.tri_data, asset.block_lo, asset.block_hi, asset.super_lo,
             asset.super_hi)
    if tri_axis is not None:
        n_tri, tri_index = _axis(mesh, tri_axis)
        asset_p = shard_asset_blocks(asset, n_tri)
        parts = block_shard(asset_p, n_tri, tri_index)
    t, slot = local_raycast(o, d, *parts, super_factor=asset_p.super_factor,
                            t_max=t_max, backend=backend)
    if tri_axis is not None:
        slot = globalize_slots(slot, tri_index, asset_p.num_blocks // n_tri,
                               asset_p.block_size)
        t, slot = combine_nearest(_all_gather(t, mesh, tri_axis),
                                  _all_gather(slot, mesh, tri_axis))
    if ray_axis is not None:
        t = _all_gather(t, mesh, ray_axis).reshape(-1)[:n]
        slot = _all_gather(slot, mesh, ray_axis).reshape(-1)[:n]
    return finalize_result(origins, dirs, t, slot, asset_p)


def sharded_raycast_rays(origins, dirs, asset: SceneAsset, mesh, axis: str = "rays",
                         backend: str = "auto", t_max: float = np.inf) -> RaycastResult:
    """Rays sharded over ``axis``, the asset whole on every rank."""
    return _sharded_cast(origins, dirs, asset, mesh, axis, None, backend, t_max)


def sharded_raycast_tris(origins, dirs, asset: SceneAsset, mesh, axis: str = "tris",
                         backend: str = "auto", t_max: float = np.inf) -> RaycastResult:
    """Leaf blocks sharded over ``axis`` (whole supers a shard), all rays on
    every rank, the nearest hit picked by ``combine_nearest``."""
    return _sharded_cast(origins, dirs, asset, mesh, None, axis, backend, t_max)


def sharded_raycast_2d(origins, dirs, asset: SceneAsset, mesh, ray_axis: str = "rays",
                       tri_axis: str = "tris", backend: str = "auto",
                       t_max: float = np.inf) -> RaycastResult:
    """Rays over ``ray_axis`` and leaf blocks over ``tri_axis`` of a 2-D
    mesh; the combine runs over the triangle axis only."""
    return _sharded_cast(origins, dirs, asset, mesh, ray_axis, tri_axis, backend, t_max)


def scan_waypoints_sharded(asset: SceneAsset, intrinsics, poses, mesh,
                           generator: Optional[torch.Generator] = None,
                           ray_axis: str = "rays", backend: str = "auto",
                           apply_range_noise: bool = False, outputs: str = "full"):
    """``sim.scan.scan_waypoints`` with its raycast sharded over ``ray_axis``.

    Every rank draws the whole beam pattern and noise stream from its own
    ``generator``, seeded alike on every rank (seed 0 when None), and casts
    its shard of the rays; the masks, noise and outputs are the one-card
    scan's code, so the result equals ``scan_waypoints`` with the same
    generator and backend.
    """
    from ipcgen_tpu_torch.sim.scan import _scan

    backend = resolve_backend(backend)
    max_range = float(intrinsics.max_range)

    def cast(o, d):
        return sharded_raycast_rays(o, d, asset, mesh, axis=ray_axis, backend=backend,
                                    t_max=max_range)

    return _scan(asset, intrinsics, poses, generator, apply_range_noise, outputs,
                 backend, cast)


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def sharded_grid_nn(queries, refs, mesh, axis: str = "rays",
                    cell_size: Optional[float] = None, cap: int = 48,
                    q_block: int = 8192) -> np.ndarray:
    """Grid-hashed 1-NN with the queries sharded over ``axis``; every rank
    builds the same grid of ``refs`` on its device.  As
    ``ops.grid_nn.nearest_neighbor_indices_grid``, a grid answer counts only
    when provably nearest (within h/2, no bucket overflow); the rest take
    the exact 1-NN on the host.  Returns (N,) int32 indices into ``refs``."""
    from ipcgen_tpu_torch.ops import grid_nn as g
    from ipcgen_tpu_torch.ops.knn import nearest_neighbor_indices

    queries = np.asarray(queries, dtype=np.float32)
    refs = np.asarray(refs, dtype=np.float32)
    n, m = len(queries), len(refs)
    if n == 0:
        return np.zeros((0,), np.int32)
    n_shards, index = _axis(mesh, axis)
    device = _mesh_device(mesh)
    if cell_size is None:
        cell_size = g._choose_cell_size(refs, cap)
    order, grid = g._grid_tensors(refs, cell_size, device)
    per = -(-n // n_shards)
    far = refs.min(axis=0) - 10 * cell_size
    qp = np.concatenate([queries, np.tile(far.astype(np.float32), (per * n_shards - n, 1))])
    q = torch.from_numpy(qp[index * per:(index + 1) * per]).to(device)
    slot, d2, ovf = g._grid_nn_core(q, *grid, int(cap), int(q_block))
    r2 = float(np.float32((0.5 * cell_size) ** 2))
    enc = torch.where((d2 <= r2) & ~ovf, slot, torch.full_like(slot, -1))
    enc = _all_gather(enc, mesh, axis).reshape(-1)[:n].cpu().numpy()
    resolved = enc >= 0
    result = order[np.clip(enc, 0, m - 1)].astype(np.int32)
    if not resolved.all():
        result[~resolved] = nearest_neighbor_indices(queries[~resolved], refs)
    return result
