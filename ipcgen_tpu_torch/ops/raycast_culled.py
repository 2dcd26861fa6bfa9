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
The result of each ray is the lexicographic minimum (t, packed slot) over
the triangles it hits with 1e-6 < t, from a start of (t_init, -1): t_init
is ``t_max`` when finite, else float32 max, so a hit at exactly ``t_max`` is
dropped and ties go to the smallest slot.  Geometry beyond the range cap or
behind a hit found earlier is culled at the AABB level.  The kernel takes
rays in warps of ``GROUP`` = 32 and walks the super blocks and their leaf
blocks nearest first; the plain version below takes the same groups and
walks the blocks in ascending order.  Both skip a block only when no ray of
the group can enter its eps-padded AABB by its current best, so both equal
the block-scan oracle (``ops/raycast.py`` ``raycast_block_scan``) bit for
bit: the same component-form arithmetic, whatever the visiting order.

``mt_prescreen_plain`` is the kernel's prescreen in torch ops (which tests
reach 1 / det), and ``visit_floors`` counts the least work these rays need.
"""

from __future__ import annotations

import numpy as np
import torch

from ipcgen_tpu_torch.ops.geometry import MT_EPS, moller_trumbore_components, ray_aabb_hit
from ipcgen_tpu_torch.ops.raycast import RaycastResult, finalize_result
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset

GROUP = 32  # rays per group: kGroup, the lanes of one warp of the kernel
# The prescreen's slack on the running best (kSlack in csrc/raycast_culled.cu):
# 1 + 16 unit roundoffs, exact in float32.
SLACK = 1.0 + 2.0 ** -20
# fl(BARY_EPS * SLACK) in float32 (kBaryK): the barycentric stages' margin.
BARY_K = float(np.float32(np.float32(1e-7) * np.float32(SLACK)))


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


def mt_prescreen_plain(ox, oy, oz, dx, dy, dz,
                       v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, best):
    """The kernel's prescreen (``mt_test`` in csrc/raycast_culled.cu) in
    torch ops: True where a ray-triangle test survives to its divide.

    With det and the numerators of u, v and t in the association of
    ``moller_trumbore_components``, it rejects when ``|det| <= 1e-9``, when
    u's or v's numerator is of the opposite sign to det and larger than
    ``|det| * fl(1e-7 * SLACK)``, when t's numerator is zero or of the
    opposite sign, or when it is larger than ``|det| * fl(best * SLACK)``;
    the kernel's comment proves that each rejected test fails exact
    Moller-Trumbore or has t > ``best``.  Every input broadcasts; float32.
    """
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    tx = ox - v0x
    ty = oy - v0y
    tz = oz - v0z
    un = tx * px + ty * py + tz * pz
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vn = dx * qx + dy * qy + dz * qz
    num = e2x * qx + e2y * qy + e2z * qz
    ad = torch.abs(det)
    flip = torch.signbit(det)
    su, sv, sn = (torch.where(flip, -x, x) for x in (un, vn, num))
    bary_thr = ad * BARY_K
    thr = ad * (best * SLACK)
    return ((ad > MT_EPS) & ~(-su > bary_thr) & ~(-sv > bary_thr) & (sn > 0)
            & ~(sn > thr))


def visit_floors(origins, dirs, block_lo, block_hi, super_lo, super_hi,
                 super_factor: int, tb: int, t_final) -> dict:
    """The least work of the culled walk for these rays: with each ray's
    best equal to its final t from the start (``t_final``: its t, or t_init
    on a miss), the leaf blocks whose AABB it enters before that t.

    - ``per_ray_tests``: those blocks summed over the rays, times TB; no
      grouping of rays can run fewer ray-triangle tests;
    - ``warp_visits``: (32-ray warp, leaf block) pairs among them, the
      kernel's groups;
    - ``group256_visits``: the same for groups of 256 consecutive rays.

    A ray that enters a leaf block enters its super, so each super's leaf
    blocks are tested on the rays that enter the super only.
    """
    dev = origins.device
    nb = block_lo.shape[0]
    ray = (origins[:, 0], origins[:, 1], origins[:, 2],
           1.0 / dirs[:, 0], 1.0 / dirs[:, 1], 1.0 / dirs[:, 2], t_final)
    per_ray = torch.zeros((), dtype=torch.int64, device=dev)
    warps = torch.zeros_like(per_ray)
    groups = torch.zeros_like(per_ray)

    def distinct(q):  # q ascending
        return (q[1:] != q[:-1]).sum() + (q.numel() > 0)

    for s in range(super_lo.shape[0]):
        rows = ray_aabb_hit(*ray[:6], super_lo[s], super_hi[s], ray[6]).nonzero().flatten()
        if not rows.numel():
            continue
        sub = [x[rows] for x in ray]
        for b in range(s * super_factor, min((s + 1) * super_factor, nb)):
            hit = rows[ray_aabb_hit(*sub[:6], block_lo[b], block_hi[b], sub[6])]
            per_ray += hit.numel()
            warps += distinct(hit // 32)
            groups += distinct(hit // 256)
    return dict(per_ray_tests=int(per_ray) * tb, warp_visits=int(warps),
                group256_visits=int(groups))


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
