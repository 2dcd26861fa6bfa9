"""Two-level AABB-culled Moller-Trumbore raycast, and the kernel's plain
PyTorch version.

Port of ``ipcgen_tpu/ops/raycast_pallas.py`` (``raycast_pallas_components``
:161-231, ``raycast_asset_pallas`` :234-258) and of its XLA twin
``raycast_xla_culled_components`` (``ipcgen_tpu/ops/raycast.py``:116-241).
What the Pallas kernel ``_raycast_kernel`` (:41-115) computes is the CUDA
kernel in ``csrc/raycast_culled.cu``, launched through ``ops/_kernels.py``;
``raycast_culled_plain`` below is the same function in plain torch ops.

How a ray is intersected
------------------------
Rays are taken in groups of ``GROUP`` consecutive rays (one CUDA block).
Each group walks the super blocks in ascending order and visits one when any
of its rays passes the slab test against its running best t; inside a
visited super it does the same for each leaf block, and for a visited leaf
block it runs Moller-Trumbore against the block's TB triangles.  The running
best starts at t_init (``t_max`` when finite, else float32 max), so geometry
beyond the range cap or behind the first hit is culled at the AABB level,
and a hit must be strictly nearer than the best: a hit at exactly ``t_max``
is dropped, and ties go to the smallest packed slot.  The result equals the
block-scan oracle (``ops/raycast.py`` ``raycast_block_scan``) bit for bit:
the same component-form arithmetic, and a block is skipped only when no ray
of the group can enter its eps-padded AABB before its current best.
"""

from __future__ import annotations

import numpy as np
import torch

from ipcgen_tpu_torch.ops.geometry import moller_trumbore_components, ray_aabb_hit
from ipcgen_tpu_torch.ops.raycast import RaycastResult, finalize_result
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset

GROUP = 256  # rays per group: kGroup, the threads of one CUDA block


def t_init_for(t_max: float) -> float:
    """The running best's start: ``t_max`` if finite, else float32 max."""
    return float(t_max) if np.isfinite(t_max) else float(np.finfo(np.float32).max)


def raycast_culled_plain(origins, dirs, tri_data, block_lo, block_hi,
                         super_lo, super_hi, super_factor: int, t_init: float,
                         stats: dict = None):
    """The kernel's function in torch ops; returns (t (R,) +inf on miss,
    packed slot (R,) int32, -1 on miss).

    The groups run side by side: at each super and leaf block, every group
    that still visits it does so with its own running best, which is what
    each group would do on its own.  Padded rays (to a multiple of
    ``GROUP``) start far outside the scene and point up, as in the JAX
    package.  ``stats``, when given, receives ``block_visits``: the number
    of (group, leaf block) visits, each ``GROUP`` rays x TB triangles of
    Moller-Trumbore.
    """
    dev = origins.device
    n = origins.shape[0]
    nb, _, tb = tri_data.shape
    ns = super_lo.shape[0]
    pad = (-n) % GROUP
    if pad:
        origins = torch.cat([origins, torch.full((pad, 3), 1e8, device=dev)])
        dirs = torch.cat([dirs, torch.tensor([[0.0, 0.0, 1.0]], device=dev)
                          .expand(pad, 3)])
    n_groups = origins.shape[0] // GROUP
    ox, oy, oz = origins[:, 0], origins[:, 1], origins[:, 2]
    dx, dy, dz = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    ix, iy, iz = 1.0 / dx, 1.0 / dy, 1.0 / dz
    best_t = torch.full((n_groups * GROUP,), t_init, dtype=torch.float32, device=dev)
    best_i = torch.full((n_groups * GROUP,), -1, dtype=torch.int32, device=dev)
    lane = torch.arange(GROUP, device=dev)

    def visiting(rows, lo, hi):
        """Per group of ``rows`` (None: all rays), does any ray pass the
        slab test?"""
        ray = [x if rows is None else x[rows]
               for x in (ox, oy, oz, ix, iy, iz, best_t)]
        return ray_aabb_hit(*ray[:6], lo, hi, ray[6]).view(-1, GROUP).any(dim=1)

    all_groups = torch.arange(n_groups, device=dev)
    visits = 0
    for s in range(ns):
        visit = visiting(None, super_lo[s], super_hi[s])
        if not bool(visit.any()):
            continue
        groups = all_groups[visit]
        for b in range(s * super_factor, min((s + 1) * super_factor, nb)):
            rows = (groups[:, None] * GROUP + lane).reshape(-1)
            visit_b = visiting(rows, block_lo[b], block_hi[b])
            n_visit = int(visit_b.sum())
            if not n_visit:
                continue
            visits += n_visit
            rows = (groups[visit_b][:, None] * GROUP + lane).reshape(-1)
            blk = tri_data[b]
            t = moller_trumbore_components(
                ox[rows, None], oy[rows, None], oz[rows, None],
                dx[rows, None], dy[rows, None], dz[rows, None],
                *(blk[k][None, :] for k in range(9)),
            )  # (rays, TB)
            tmin, targ = torch.min(t, dim=1)
            bt = best_t[rows]
            take = tmin < bt
            best_t[rows] = torch.where(take, tmin, bt)
            best_i[rows] = torch.where(take, targ.int() + b * tb, best_i[rows])
    if stats is not None:
        stats["block_visits"] = visits
    t_out = torch.where(best_i >= 0, best_t, torch.full_like(best_t, float("inf")))
    return t_out[:n], best_i[:n]


def raycast_culled_components(origins, dirs, tri_data, block_lo, block_hi,
                              super_lo, super_hi, *, super_factor: int,
                              t_max: float = np.inf):
    """Culled raycast over raw asset components; returns (t, packed slot).
    The leaf block size is ``tri_data.shape[2]``.

    CUDA tensors go to the kernel, CPU tensors to its plain version; any
    other device raises.
    """
    origins = origins.float().contiguous()
    dirs = dirs.float().contiguous()
    args = (origins, dirs, tri_data, block_lo, block_hi, super_lo, super_hi,
            super_factor, t_init_for(t_max))
    if origins.device.type == "cuda":
        from ipcgen_tpu_torch.ops import _kernels

        return _kernels.raycast_culled_cuda(*args)
    if origins.device.type == "cpu":
        return raycast_culled_plain(*args)
    raise ValueError(f"raycast_culled: unsupported device {origins.device}")


def raycast_asset_culled(origins, dirs, asset: SceneAsset,
                         t_max: float = np.inf) -> RaycastResult:
    """Intersect rays with the resident scene through the culled kernel."""
    origins = origins.float()
    dirs = dirs.float()
    t, slot = raycast_culled_components(
        origins, dirs, asset.tri_data, asset.block_lo, asset.block_hi,
        asset.super_lo, asset.super_hi, super_factor=asset.super_factor,
        t_max=t_max,
    )
    return finalize_result(origins, dirs, t, slot, asset)
