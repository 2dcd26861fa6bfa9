"""Candidate-pair raycast: prepass, pair list, entry points, and the
kernels' plain PyTorch versions.

Port of ``ipcgen_tpu/ops/raycast_mxu.py``: ``build_trif``/``ray_features``
(:110-202), the hierarchical candidate prepass (:208-401), the pair list
(:800-844), the ray sort (:886-904) and ``raycast_mxu_components``
(:907-1152).  Two CUDA kernels in ``csrc/raycast_pairs.cu``, launched
through ``ops/_kernels.py``, do the work on the card: the exact prepass
(the counterpart of the XLA ``candidate_blocks``; plain version
``exact_prepass_plain``) and the pair walk (what the Pallas kernels
``_flat_kernel`` :619-732 and its exact fallback ``_pairs_kernel`` :470-592
compute; plain version ``raycast_pairs_plain``).

How a ray is intersected
------------------------
Rays are cut into tiles of 2048 rays (1024 when ray-sorted) and each tile
into subtiles of 256 rays.  The prepass gives each subtile the exact,
ascending list of leaf blocks any of its rays can enter within ``t_max``
(two slab-test stages: block groups, then the blocks of the groups that were
hit; the kernel tests mega boxes of ``MEGA`` groups first, which
``prepass_model`` models), as a CSR pair list (``offsets``, ``blocks``).
Nothing caps the lists.
The JAX package capped each tile at ``gmax`` groups and ``vmax`` blocks and
sent a tile over either cap down a walk-all fallback; the port keeps that
overflow predicate only as a statistic (``overflow``, ``overflow_frac``),
which decides the "auto" ray sort as in JAX.  The pair walk runs over the
(subtile, block) pairs in parallel.  A caller may still mark subtiles
``walk_all``: ``expand_walk_all`` then lists every block for them.

For each (ray, triangle) the five Pluecker products of ``build_trif`` give
three edge sides, ``t_num`` and ``t_den``, all in float32 (the TPU's bf16x3
split for the MXU has no counterpart here).  ``|num| > 1e-6 |den|``
enforces t > 1e-6, ``|den| > 1e-9`` rejects plane-parallel rays (so the 0/0
of a padded triangle never wins) and num must have den's sign.  The running
best starts at (t_init, -1); a candidate replaces it when its t is smaller,
or equal with a smaller packed slot (the Pallas kernels' tie rule).

The edge test: closed triangles, decided exactly
------------------------------------------------
A triangle is hit when each of its three sides is 0 or has den's sign
(closed triangles, as the oracle's ``u >= -eps``, ``v >= -eps``,
``u + v <= 1 + eps``): a ray on a shared edge or vertex is inside every
triangle that meets there, and the tie rule picks one.  The float32 sides
are computed about a scene centre, where terms of |p||q| cancel down to the
small side of a grazing ray, so a float32 sign near 0 is not to be trusted.
``side_band`` bounds the float32 side's error for a (ray, block): with
u = 2^-24, R the block's largest centred vertex coordinate
(``block_radius``) and the ray's features d, m = (o - c) x d and o - c,

    |side32 - side| <= u R (BAND_D R |d|_1 + BAND_M |m|_1
                            + BAND_OD |o - c|_inf |d|_inf),

where side is the exact side of the float32 inputs (the vertices v0,
v0 + e1, v0 + e2 and the ray o, d in real arithmetic; it does not depend on
the centre).  Per coordinate, the centred vertices carry <= 2.01 u R (one
rounding of v0 - c, one of + e), so a cross-product coordinate of
``build_trif`` is off by <= 4.01 u R^2 (its own rounding) + 8.04 u R^2 (its
rounded vertices), an edge vector by <= 6.03 u R and a coordinate of m by
<= 6.01 u |o - c|_inf |d|_inf; the six-term dot product adds <= 10.1 u times
the sum of its terms' magnitudes, 2 R^2 |d|_1 + 2 R |m|_1, in any summation
order, with or without FMA (which covers the plain version's ten-term
matmul: its other four terms are exact zeros).  Summed, 32.3, 26.3 and 36.2,
rounded up for the float32 evaluation of the band itself.

A side beyond the band has the exact side's sign, so a triangle with one on
the wrong side is rejected in float32, and one with all three on den's side
is hit.  Otherwise, and only when its t would replace the running best,
float64 decides: the three sides again from the raw inputs, ``tri_data``
rows 0-8 and the ray's own float32 o and d, about the ray's origin rather
than a scene centre (``sides_f64``: d.((p - o) x (q - o)), where the
vertex differences are exact for a scene's coordinates and a ray that
passes an edge by 1e-16 m keeps its sign), each product and sum rounded on
its own in one fixed order, so the kernel's float64 sides equal the plain
version's bit for bit and a shared edge's two sides are exact negatives.
t stays the float32 ``|num| / |den|``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ipcgen_tpu_torch.ops.raycast import RaycastResult, finalize_result
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset

SUB_MAX = 256  # rays per subtile
N_FEAT = 10  # ray feature rows: [d, (o - c) x d, o - c, 1]
EPS_T = 1e-6  # t > eps as |num| > eps * |den|
EPS_DEN = 1e-9  # |t_den| > eps
_BIG = 3.0e38
_INT32_MAX = 2**31 - 1
# The float32 side's error bound (module docstring; kBand* in
# csrc/raycast_pairs.cu): u times these.
BAND_U = 2.0**-24
BAND_D = 33.0
BAND_M = 27.0
BAND_OD = 37.0
_RADIUS_SLACK = 1.0 + 2.0**-20  # R and |o - c| also bound the exact values


def _elem_budget(device: torch.device, cuda: int, cpu: int) -> int:
    return cuda if device.type == "cuda" else cpu


# ---------------------------------------------------------------------------
# Triangle panels and ray features
# ---------------------------------------------------------------------------
def build_trif(tri_data: torch.Tensor, center: torch.Tensor = None) -> torch.Tensor:
    """(NB, 16, TB) v0/e1/e2 panels -> (NB, 10, 5*TB) float32 Pluecker panels.

    Column groups (each TB wide): [s0 | s1 | s2 | t_num | t_den] against the
    ray feature rows [dx dy dz  mx my mz  ox oy oz  1] (``ray_features``).
    For an edge p -> q the side is d.(p x q) + m.(q - p); t_num = v0.n - o.n
    and t_den = d.n with n = e1 x e2.  ``center`` is subtracted from the
    geometry first (the rays' features subtract the same point), which keeps
    the moment terms small.  A padded triangle has n = 0, so t_num = t_den = 0.
    """
    if center is None:
        center = torch.zeros(3, dtype=torch.float32, device=tri_data.device)
    v0 = tri_data[:, 0:3] - center[None, :, None]  # (NB, 3, TB)
    e1 = tri_data[:, 3:6]
    e2 = tri_data[:, 6:9]
    a, b, c = v0, v0 + e1, v0 + e2

    def cross(u, v):
        return torch.stack(
            [
                u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0],
            ],
            dim=1,
        )

    nb, _, tb = v0.shape
    z = lambda rows: torch.zeros((nb, rows, tb), dtype=torch.float32,
                                 device=tri_data.device)

    def edge_cols(p, q):
        return torch.cat([cross(p, q), q - p, z(4)], dim=1)

    n = cross(e1, e2)
    cplane = torch.sum(v0 * n, dim=1, keepdim=True)
    tnum = torch.cat([z(6), -n, cplane], dim=1)
    tden = torch.cat([n, z(7)], dim=1)
    return torch.cat(
        [edge_cols(a, b), edge_cols(b, c), edge_cols(c, a), tnum, tden], dim=2
    ).contiguous()


def ray_features(origins: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """(R, 3) o, d -> (R, 10) [d, o x d, o, 1]."""
    m = torch.stack(
        [
            origins[:, 1] * dirs[:, 2] - origins[:, 2] * dirs[:, 1],
            origins[:, 2] * dirs[:, 0] - origins[:, 0] * dirs[:, 2],
            origins[:, 0] * dirs[:, 1] - origins[:, 1] * dirs[:, 0],
        ],
        dim=1,
    )
    one = torch.ones((origins.shape[0], 1), dtype=torch.float32,
                     device=origins.device)
    return torch.cat([dirs, m, origins, one], dim=1).contiguous()


def block_radius(tri_data: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """(NB,) float32 R of ``side_band``: the largest |coordinate| of the
    centred vertices ``build_trif`` rounds (v0 - c, then + e1, + e2) over the
    block's triangles whose float32 normal is not 0, times a slack that makes
    it bound the exact centred vertices too; 0 for a block with no such
    triangle.  A triangle with a zero normal has den = 0 and is never hit,
    so it needs no bound (the asset's far-away padding is one)."""
    v0 = tri_data[:, 0:3] - center[None, :, None]  # (NB, 3, TB)
    e1, e2 = tri_data[:, 3:6], tri_data[:, 6:9]
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=1)
    live = (n != 0).any(dim=1)  # (NB, TB)
    r = torch.stack([v0, v0 + e1, v0 + e2]).abs().amax(dim=(0, 2))  # (NB, TB)
    r = torch.where(live, r, torch.zeros_like(r)).amax(dim=1)
    return (r * _RADIUS_SLACK).contiguous()


def ray_band_terms(f: torch.Tensor):
    """(R, 10) ray features -> (kd, km) (R,) float32 with ``side_band`` =
    R (R kd + km): kd = BAND_D u |d|_1, km = BAND_M u |m|_1 +
    BAND_OD u |o - c|_inf |d|_inf, in the kernel's order of operations
    (``fmax`` as CUDA's fmaxf)."""
    a = f[:, 0:9].abs()
    d1 = (a[:, 0] + a[:, 1]) + a[:, 2]
    d_inf = torch.fmax(torch.fmax(a[:, 0], a[:, 1]), a[:, 2])
    m1 = (a[:, 3] + a[:, 4]) + a[:, 5]
    rho = torch.fmax(torch.fmax(a[:, 6], a[:, 7]), a[:, 8]) * _RADIUS_SLACK
    kd = d1 * (BAND_U * BAND_D)
    km = m1 * (BAND_U * BAND_M) + (rho * d_inf) * (BAND_U * BAND_OD)
    return kd, km


def side_band(radius: torch.Tensor, kd: torch.Tensor, km: torch.Tensor) -> torch.Tensor:
    """The float32 side's error bound (module docstring) for blocks of
    ``radius`` and rays of ``ray_band_terms``, broadcast: R (R kd + km)."""
    return radius * (radius * kd + km)


def sides_f64(o: torch.Tensor, d: torch.Tensor, tri9: torch.Tensor) -> torch.Tensor:
    """(n, 3) float64 edge sides of rays o, d (n, 3) float32 against
    triangles given as ``tri_data`` rows 0-8 (n, 9) float32 (v0, e1, e2),
    about the ray's own origin: for the edges a -> b, b -> c, c -> a of
    a = v0, b = v0 + e1, c = v0 + e2, the side d.((p - o) x (q - o)) (the
    Pluecker side with the moment o x d = 0, so no scene centre enters).
    Each product and sum is rounded on its own, in this order (the
    kernel's ``inside_f64``)."""
    o, d, tri9 = o.double(), d.double(), tri9.double()
    v0 = tri9[:, 0:3]
    a, b, c = v0 - o, (v0 + tri9[:, 3:6]) - o, (v0 + tri9[:, 6:9]) - o

    def side(p, q):
        cx = p[:, 1] * q[:, 2] - p[:, 2] * q[:, 1]
        cy = p[:, 2] * q[:, 0] - p[:, 0] * q[:, 2]
        cz = p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0]
        return (d[:, 0] * cx + d[:, 1] * cy) + d[:, 2] * cz

    return torch.stack([side(a, b), side(b, c), side(c, a)], dim=1)


def inside_f64(sides: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """(n,) bool: each float64 side is 0 or has the sign of ``den`` (n,)
    (closed triangles); NaN is outside."""
    pos = (den > 0)[:, None]
    neg = (den < 0)[:, None]
    return ((sides == 0) | ((sides > 0) & pos) | ((sides < 0) & neg)).all(dim=1)


# ---------------------------------------------------------------------------
# Candidate prepass
# ---------------------------------------------------------------------------
def _nanmin(x: torch.Tensor, dim: int) -> torch.Tensor:
    nan = torch.isnan(x)
    m = torch.where(nan, torch.full_like(x, float("inf")), x).amin(dim)
    return torch.where(nan.all(dim), torch.full_like(m, float("nan")), m)


def _nanmax(x: torch.Tensor, dim: int) -> torch.Tensor:
    nan = torch.isnan(x)
    m = torch.where(nan, torch.full_like(x, float("-inf")), x).amax(dim)
    return torch.where(nan.all(dim), torch.full_like(m, float("nan")), m)


def _tile_slab_or(o_t, d_t, box_lo, box_hi, t_max: float, subtiles: int = 1):
    """Per-tile OR-reduced slab masks.

    o_t/d_t (T, tile, 3); box_lo/box_hi either (C, 3) shared boxes or
    (T, C, 3) per-tile boxes.  Returns (T, C) bool (does any ray of the tile
    enter box c within [0, t_max)?) or, with ``subtiles`` = S > 1, (T, S, C)
    per contiguous tile/S-ray subtile.  Chunked over tiles; NaN boxes never
    pass.
    """
    n_tiles, tile, _ = o_t.shape
    per_tile = box_lo.dim() == 3
    n_box = box_lo.shape[-2]
    tiny = torch.full_like(d_t, 1e-12)
    d_safe = torch.where(d_t.abs() < 1e-12, torch.where(d_t < 0, -tiny, tiny), d_t)
    inv = 1.0 / d_safe
    budget = _elem_budget(o_t.device, 1 << 25, 1 << 21)
    chunk = max(1, budget // max(tile * n_box, 1))
    outs = []
    for s in range(0, n_tiles, chunk):
        o = o_t[s:s + chunk, :, None, :]  # (k, tile, 1, 3)
        iv = inv[s:s + chunk, :, None, :]
        if per_tile:
            lo = box_lo[s:s + chunk, None]  # (k, 1, C, 3)
            hi = box_hi[s:s + chunk, None]
        else:
            lo = box_lo[None, None]  # (1, 1, C, 3)
            hi = box_hi[None, None]
        entry = exit_ = None
        for ax in range(3):
            t1 = (lo[..., ax] - o[..., ax]) * iv[..., ax]
            t2 = (hi[..., ax] - o[..., ax]) * iv[..., ax]
            lo_t, hi_t = torch.minimum(t1, t2), torch.maximum(t1, t2)
            if entry is None:
                entry = torch.maximum(torch.full_like(lo_t, -_BIG), lo_t)
                exit_ = torch.minimum(torch.full_like(hi_t, _BIG), hi_t)
            else:
                entry = torch.maximum(entry, lo_t)
                exit_ = torch.minimum(exit_, hi_t)
        hit = (exit_ >= torch.maximum(entry, torch.zeros_like(entry))) & (entry < t_max)
        if subtiles > 1:
            k = hit.shape[0]
            outs.append(hit.view(k, subtiles, tile // subtiles, n_box).any(dim=2))
        else:
            outs.append(hit.any(dim=1))
    return torch.cat(outs)


def _compact_ids(mask: torch.Tensor, vals: torch.Tensor):
    """Stable-compact True positions of (T, C) mask to the front, carrying
    ``vals``; returns (vals_sorted, counts int32)."""
    key = (~mask).to(torch.int32)
    _, idx = torch.sort(key, dim=1, stable=True)
    return vals.gather(1, idx), mask.sum(dim=1).to(torch.int32)


def candidate_blocks(origins, dirs, block_lo, block_hi, *, t_max: float,
                     vmax: int = 256, group: int = 8, gmax: int = 48,
                     tile: int = 1024, n_sub: int = 4):
    """Per-tile candidate block lists via hierarchical exact slab tests.

    Stage 1 slab-tests every ray against block GROUPS (``group`` consecutive
    Morton-ordered blocks, NaN-aware AABB union); stage 2 tests each tile's
    rays against the blocks of its <= ``gmax`` candidate groups.  A ray
    inside a block is inside its group, so the lists are exact.

    Returns (ids (V, T) int32, counts (T,) int32, overflow (T,) bool,
    masks (V, T) int32) with V = min(vmax, gmax*group): each tile's candidate
    block ids ascending, then the rest; ``masks`` holds ``n_sub``-bit subtile
    masks.  ``origins``/``dirs`` must be padded to a ``tile`` multiple.
    """
    dev = origins.device
    n = origins.shape[0]
    n_tiles = n // tile
    nb = block_lo.shape[0]
    o_t = origins.view(n_tiles, tile, 3)
    d_t = dirs.view(n_tiles, tile, 3)

    ng = -(-nb // group)
    gmax = min(gmax, ng)
    pad_b = ng * group - nb
    nanrows = torch.full((pad_b + group, 3), float("nan"), device=dev)
    blo_p = torch.cat([block_lo, nanrows])  # + one sentinel group of NaN blocks
    bhi_p = torch.cat([block_hi, nanrows])
    glo = _nanmin(blo_p[: ng * group].view(ng, group, 3), dim=1)
    ghi = _nanmax(bhi_p[: ng * group].view(ng, group, 3), dim=1)

    mask_g = _tile_slab_or(o_t, d_t, glo, ghi, t_max)  # (T, NG)
    gids = torch.arange(ng, dtype=torch.int32, device=dev).expand(n_tiles, ng)
    gids_sorted, counts_g = _compact_ids(mask_g, gids)
    overflow = counts_g > gmax

    ar_g = torch.arange(gmax, device=dev)
    gsel = torch.where(ar_g[None, :] < counts_g[:, None], gids_sorted[:, :gmax],
                       torch.full_like(gids_sorted[:, :gmax], ng))
    block_ids = (
        gsel[:, :, None] * group
        + torch.arange(group, dtype=torch.int32, device=dev)
    ).reshape(n_tiles, gmax * group)
    idx = block_ids.long()
    mask_s = _tile_slab_or(o_t, d_t, blo_p[idx], bhi_p[idx], t_max,
                           subtiles=n_sub)
    if n_sub == 1:
        bits = mask_s.to(torch.int32)
    else:
        bits = torch.zeros(mask_s.shape[0], mask_s.shape[2], dtype=torch.int32,
                           device=dev)
        for s in range(n_sub):
            bits = bits | (mask_s[:, s, :].to(torch.int32) << s)
    packed_sorted, counts = _compact_ids(bits > 0, (block_ids << n_sub) | bits)
    overflow = overflow | (counts > vmax)
    ids_sorted = packed_sorted >> n_sub
    masks_sorted = packed_sorted & ((1 << n_sub) - 1)
    return (
        ids_sorted[:, :vmax].T.contiguous(),
        counts,
        overflow,
        masks_sorted[:, :vmax].T.contiguous(),
    )


def subtile_pairs(ids, counts, overflow, masks, n_sub: int):
    """Per-subtile candidate lists from the prepass (the port of
    ``_build_pair_list``; no pair budget or spill: nothing bounds it here).

    Returns (offsets (S+1,) int32, blocks (P,) int32, walk_all (S,) int32)
    for S = T * n_sub subtiles in ray order: subtile s walks
    ``blocks[offsets[s]:offsets[s+1]]`` (ascending), or every block when
    ``walk_all[s]`` is set (its tile overflowed; its list is then empty).
    """
    dev = ids.device
    vmax, n_tiles = ids.shape
    j = torch.arange(vmax, device=dev)[:, None]
    live = (j < counts[None, :]) & ~overflow[None, :]  # (V, T)
    shifts = torch.arange(n_sub, dtype=torch.int32, device=dev)
    sel = live[:, :, None] & (((masks[:, :, None] >> shifts) & 1) != 0)
    nz = sel.permute(1, 2, 0).nonzero()  # rows (tile, subtile, j), row-major
    blocks = ids[nz[:, 2], nz[:, 0]].to(torch.int32).contiguous()
    sub_id = nz[:, 0] * n_sub + nz[:, 1]
    cnt = torch.bincount(sub_id, minlength=n_tiles * n_sub)
    offsets = torch.zeros(n_tiles * n_sub + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(cnt, 0).to(torch.int32)
    walk_all = overflow.repeat_interleave(n_sub).to(torch.int32)
    return offsets, blocks, walk_all.contiguous()


def group_boxes(block_lo, block_hi, group: int):
    """(NG, 3) lo and hi of the block groups: the NaN-aware AABB union of
    ``group`` consecutive blocks, NaN for a group of padding only (as in
    ``candidate_blocks``)."""
    nb = block_lo.shape[0]
    ng = -(-nb // group)
    nanrows = torch.full((ng * group - nb, 3), float("nan"), device=block_lo.device)
    glo = _nanmin(torch.cat([block_lo, nanrows]).view(ng, group, 3), dim=1)
    ghi = _nanmax(torch.cat([block_hi, nanrows]).view(ng, group, 3), dim=1)
    return glo.contiguous(), ghi.contiguous()


MEGA = 8  # groups per mega box (kMega in csrc/raycast_pairs.cu)


def mega_boxes(group_lo, group_hi):
    """(NM, 3) lo and hi of the mega boxes, NM = ceil(NG / MEGA): per axis
    the least and the greatest of the non-NaN lo and hi coordinates of
    ``MEGA`` consecutive groups (the union of the boxes as point sets, which
    is their AABB union when lo <= hi), NaN where all are NaN."""
    ng = group_lo.shape[0]
    nm = -(-ng // MEGA)
    nanrows = torch.full((nm * MEGA - ng, 3), float("nan"), device=group_lo.device)
    lo = torch.cat([group_lo, nanrows]).view(nm, MEGA, 3)
    hi = torch.cat([group_hi, nanrows]).view(nm, MEGA, 3)
    both = torch.cat([lo, hi], dim=1)
    return _nanmin(both, dim=1).contiguous(), _nanmax(both, dim=1).contiguous()


def checked_tiles(origins, dirs, t_max: float, tile: int):
    """(T,) bool: the tiles the prepass kernel runs on its checked path,
    which tests every group with NaN checks and no mega level: a tile with a
    non-finite ray component, or every tile when t_max is not in
    (0, 3e38]."""
    n_tiles = origins.shape[0] // tile
    finite = torch.isfinite(origins.view(n_tiles, -1)).all(1) & \
        torch.isfinite(dirs.view(n_tiles, -1)).all(1)
    if not 0.0 < t_max <= _BIG:
        return torch.ones_like(finite)
    return ~finite


def prepass_model(origins, dirs, block_lo, block_hi, *, t_max: float, group: int,
                  tile: int, n_sub: int):
    """Plain model of ``pairs_prepass_kernel``'s three levels: each tile's
    rays against the mega boxes, then the groups of the megas any of them
    enters, then the blocks of the groups any of them enters (a checked tile,
    ``checked_tiles``, tests every group).  It gives ``exact_prepass_plain``'s
    four outputs when no level prunes a box that a ray enters (the argument
    in the kernel's header), and the boxes the kernel considers at each
    level, each counted once for every ray of its tile:
    (offsets, blocks, groups, union, counts) with counts ``mega_tests``,
    ``group_tests``, ``block_tests``, ``checked_tiles``."""
    dev = origins.device
    n_tiles = origins.shape[0] // tile
    nb = block_lo.shape[0]
    ng = -(-nb // group)
    o_t, d_t = origins.view(n_tiles, tile, 3), dirs.view(n_tiles, tile, 3)
    glo, ghi = group_boxes(block_lo, block_hi, group)
    mlo, mhi = mega_boxes(glo, ghi)
    nm = mlo.shape[0]
    checked = checked_tiles(origins, dirs, t_max, tile)
    mega_hit = _tile_slab_or(o_t, d_t, mlo, mhi, t_max) & ~checked[:, None]
    cand = mega_hit.repeat_interleave(MEGA, dim=1)[:, :ng] | checked[:, None]
    group_hit = _tile_slab_or(o_t, d_t, glo, ghi, t_max) & cand
    # The blocks of each tile's hit groups, ascending (padding ids >= NB
    # stand for NaN boxes, which no ray enters).
    gids = torch.arange(ng, dtype=torch.int32, device=dev).expand(n_tiles, ng)
    gids_sorted, counts_g = _compact_ids(group_hit, gids)
    gmax = max(int(counts_g.max()), 1)
    gsel = torch.where(torch.arange(gmax, device=dev)[None, :] < counts_g[:, None],
                       gids_sorted[:, :gmax], torch.full_like(gids_sorted[:, :gmax], ng))
    block_ids = (gsel[:, :, None] * group
                 + torch.arange(group, dtype=torch.int32, device=dev)).reshape(n_tiles, -1)
    nanrows = torch.full((ng * group + group - nb, 3), float("nan"), device=dev)
    idx = block_ids.long()
    blo_p, bhi_p = torch.cat([block_lo, nanrows]), torch.cat([block_hi, nanrows])
    hit = _tile_slab_or(o_t, d_t, blo_p[idx], bhi_p[idx], t_max, subtiles=n_sub)
    hit = hit.view(n_tiles, n_sub, -1)  # (T, S, gmax * group)
    nz = hit.reshape(n_tiles * n_sub, -1).nonzero()
    offsets = torch.zeros(n_tiles * n_sub + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(hit.reshape(n_tiles * n_sub, -1).sum(1), 0).to(torch.int32)
    blocks = block_ids[nz[:, 0] // n_sub, nz[:, 1]]
    groups = group_hit.sum(1).to(torch.int32)
    # Boxes considered: every mega on an unchecked tile, the groups of its
    # hit megas (every group on a checked tile), the blocks of its hit groups.
    group_sizes = (torch.arange(ng, device=dev) + 1) * group
    group_sizes = torch.clamp(group_sizes, max=nb) - torch.arange(ng, device=dev) * group
    mega_sizes = torch.clamp((torch.arange(nm, device=dev) + 1) * MEGA, max=ng) \
        - torch.arange(nm, device=dev) * MEGA
    counts = dict(
        mega_tests=int((~checked).sum()) * nm * tile,
        group_tests=(int((mega_hit.long() * mega_sizes).sum())
                     + int(checked.sum()) * ng) * tile,
        block_tests=int((group_hit.long() * group_sizes).sum()) * tile,
        checked_tiles=int(checked.sum()),
    )
    union = hit.any(dim=1).sum(1).to(torch.int32)
    return offsets, blocks.to(torch.int32).contiguous(), groups, union, counts


FLOOR_RAYS = {"per_ray_tests": 1, "warp32_tests": 32, "subtile_tests": 256}


def prepass_floors(origins, dirs, block_lo, block_hi, *, t_max: float, group: int,
                   tile: int, chunk_rays: int = 1 << 15) -> dict:
    """The least slab tests of the three-level prepass for these rays.

    Rays descend in sets of k consecutive rays (``FLOOR_RAYS``: k = 1, 32,
    256, and ``tile_tests`` for k = ``tile``, the kernel's own sets): every
    ray of a set tests each mega, then the groups of the megas some ray of
    the set enters, then the blocks of the groups some ray of the set enters.
    A ray of a checked tile (``checked_tiles``) tests every group and no
    mega, as the kernel's checked form does.  Boxes with a NaN coordinate are
    skipped, not tested.  A ray that enters a block enters its group and
    that group's mega (the argument in csrc/raycast_pairs.cu), so with k = 1
    these are the tests that give each ray the blocks it enters, and no
    grouping of rays needs fewer.  Returns {name: tests}.
    """
    n = origins.shape[0]
    glo, ghi = group_boxes(block_lo, block_hi, group)
    mlo, mhi = mega_boxes(glo, ghi)
    ng, nm = glo.shape[0], mlo.shape[0]

    def valid(lo, hi, size, per):  # non-NaN boxes, counted per parent
        ok = ~(torch.isnan(lo).any(1) | torch.isnan(hi).any(1))
        ok = torch.cat([ok, ok.new_zeros(size * per - ok.numel())])
        return ok.view(size, per).sum(1)

    blocks_per_group = valid(block_lo, block_hi, ng, group)
    groups_per_mega = valid(glo, ghi, nm, MEGA)
    n_megas = int((~(torch.isnan(mlo).any(1) | torch.isnan(mhi).any(1))).sum())
    n_groups = int(groups_per_mega.sum())
    checked = checked_tiles(origins, dirs, t_max, tile).repeat_interleave(tile)
    sizes = dict(FLOOR_RAYS, tile_tests=tile)
    totals = dict.fromkeys(sizes, 0)
    chunk = max(1, chunk_rays // tile) * tile
    for s in range(0, n, chunk):
        o, d, chk = origins[s:s + chunk], dirs[s:s + chunk], checked[s:s + chunk]
        o_r, d_r = o[:, None, :], d[:, None, :]  # one ray a tile
        mega_hit = _tile_slab_or(o_r, d_r, mlo, mhi, t_max) & ~chk[:, None]
        cand = mega_hit.repeat_interleave(MEGA, dim=1)[:, :ng] | chk[:, None]
        group_hit = _tile_slab_or(o_r, d_r, glo, ghi, t_max) & cand
        for name, k in sizes.items():
            m_k = mega_hit.view(-1, k, nm).any(1).long()
            g_k = group_hit.view(-1, k, ng).any(1).long()
            c_k = chk.view(-1, k)[:, 0].long()
            per_set = ((1 - c_k) * n_megas + c_k * n_groups
                       + (m_k * groups_per_mega).sum(1) + (g_k * blocks_per_group).sum(1))
            totals[name] += int(per_set.sum()) * k
    return totals


def exact_prepass_plain(origins, dirs, block_lo, block_hi, *, t_max: float,
                        group: int, tile: int, n_sub: int):
    """Plain PyTorch version of ``pairs_prepass_kernel``: ``candidate_blocks``
    with no cap (every group, vmax = NB), then ``subtile_pairs``.

    ``origins``/``dirs`` padded to a ``tile`` multiple.  Returns (offsets
    (S+1,) int32, blocks (P,) int32, groups (T,) int32 block groups each
    tile crosses, union (T,) int32 blocks in the union of its subtiles'
    lists).
    """
    nb = block_lo.shape[0]
    ng = -(-nb // group)
    if nb >= (1 << (31 - n_sub)):  # candidate_blocks packs ids with subtile bits
        raise ValueError(f"block count must be < 2^{31 - n_sub}, got {nb}")
    ids, counts, ovf, masks = candidate_blocks(
        origins, dirs, block_lo, block_hi, t_max=t_max, vmax=nb, group=group,
        gmax=ng, tile=tile, n_sub=n_sub)
    offsets, blocks, _ = subtile_pairs(ids, counts, ovf, masks, n_sub)
    n_tiles = origins.shape[0] // tile
    glo, ghi = group_boxes(block_lo, block_hi, group)
    groups = _tile_slab_or(origins.view(n_tiles, tile, 3), dirs.view(n_tiles, tile, 3),
                           glo, ghi, t_max).sum(dim=1).to(torch.int32)
    return offsets, blocks, groups, counts


def exact_prepass(origins, dirs, block_lo, block_hi, *, t_max: float, group: int,
                  tile: int, n_sub: int):
    """The prepass kernel for CUDA tensors, its plain version for CPU
    tensors; see ``exact_prepass_plain``."""
    if origins.device.type == "cuda":
        from ipcgen_tpu_torch.ops import _kernels

        return _kernels.raycast_pairs_prepass_cuda(
            origins, dirs, block_lo, block_hi, *group_boxes(block_lo, block_hi, group),
            group, t_max, n_sub)
    if origins.device.type == "cpu":
        return exact_prepass_plain(origins, dirs, block_lo, block_hi, t_max=t_max,
                                   group=group, tile=tile, n_sub=n_sub)
    raise ValueError(f"exact_prepass: unsupported device {origins.device}")


# ---------------------------------------------------------------------------
# The pair walk: pair list, plain version and dispatch
# ---------------------------------------------------------------------------
def expand_walk_all(offsets, blocks, walk_all, nb: int):
    """The flat pair list with every block 0..nb-1 listed, in order, for
    each subtile whose ``walk_all`` flag is set (its own list is dropped).
    ``walk_all`` None, or no flag set, leaves the list as it is."""
    if walk_all is None or not bool(walk_all.any()):
        return offsets, blocks
    dev = offsets.device
    counts = (offsets[1:] - offsets[:-1]).long()
    walk = walk_all != 0
    new_counts = torch.where(walk, torch.full_like(counts, nb), counts)
    new_offsets = torch.zeros_like(offsets)
    new_offsets[1:] = torch.cumsum(new_counts, 0).to(torch.int32)
    n_pairs = int(new_offsets[-1])
    pair_sub = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                       new_counts, output_size=n_pairs)
    j = torch.arange(n_pairs, device=dev) - new_offsets[pair_sub].long()
    new_blocks = j.to(torch.int32)  # a walk-all subtile's j-th pair is block j
    keep = ~walk[pair_sub]
    new_blocks[keep] = blocks[(offsets[pair_sub].long() + j)[keep]]
    return new_offsets, new_blocks


def raycast_pairs_plain(w: dict):
    """Plain PyTorch version of ``raycast_pairs_kernel`` (same inputs, same
    guards, same edge test, same tie rule), over the walk keys of ``w``
    (``prepare_pairs``' dict):

    ``f`` (S*sub, 10) ray features of ``origins``, ``dirs`` (S*sub, 3), the
    raw float32 rays; ``trif`` (NB, 10, 5*TB) the panels of ``tri_data``
    (NB, 16, TB), ``radius`` (NB,) their ``block_radius``; the flat pair
    list ``offsets`` (S+1,), ``blocks`` (P,): subtile s walks
    ``blocks[offsets[s]:offsets[s+1]]``; ``t_init`` the initial best t.
    Returns (t (S*sub,) float32, +inf on a miss; slot (S*sub,) int32 packed
    block*TB + lane, -1 on a miss).
    """
    f, trif, offsets, blocks = w["f"], w["trif"], w["offsets"], w["blocks"]
    origins, dirs, tri_data, radius = w["origins"], w["dirs"], w["tri_data"], w["radius"]
    t_init, sub = w["t_init"], w["sub"]
    dev = f.device
    n_subtiles = offsets.shape[0] - 1
    width = trif.shape[2]
    tb = width // 5
    n_rays = n_subtiles * sub
    counts = (offsets[1:] - offsets[:-1]).long()
    pair_sub = torch.repeat_interleave(
        torch.arange(n_subtiles, device=dev), counts)
    pair_blk = blocks.long()

    feats = f.view(n_subtiles, sub, N_FEAT)
    kd, km = (k.view(n_subtiles, sub, 1) for k in ray_band_terms(f))
    best_t = torch.full((n_rays,), float(t_init), device=dev)
    best_s = torch.full((n_rays,), -1, dtype=torch.int32, device=dev)
    lane_rays = torch.arange(sub, device=dev)
    chunk = max(1, _elem_budget(dev, 1 << 26, 1 << 21) // (sub * width))
    for c in range(0, pair_sub.numel(), chunk):
        ps, pb = pair_sub[c:c + chunk], pair_blk[c:c + chunk]
        g = torch.bmm(feats[ps], trif[pb])  # (k, sub, 5*TB)
        s0, s1, s2, num, den = g.split(tb, dim=2)
        iden = den.view(torch.int32)
        flip = iden & torch.iinfo(torch.int32).min  # den's sign bit
        # The sides as seen from den's side: inside is >= 0.
        lo = torch.fmin(torch.fmin((s0.view(torch.int32) ^ flip).view(torch.float32),
                                   (s1.view(torch.int32) ^ flip).view(torch.float32)),
                        (s2.view(torch.int32) ^ flip).view(torch.float32))
        r = radius[pb][:, None, None]
        band = side_band(r, kd[ps], km[ps])  # (k, sub, 1)
        an, ad = num.abs(), den.abs()
        ok = ~(lo < -band) & ((num.view(torch.int32) ^ iden) >= 0) \
            & (an > EPS_T * ad) & (ad > EPS_DEN)
        # A side within the band: float64 decides (the kernel asks it only
        # where t would replace its running best; the result is the same).
        unsure = ok & ~(lo > band)
        if bool(unsure.any()):
            k_i, j_i, l_i = unsure.nonzero(as_tuple=True)
            ray = ps[k_i] * sub + j_i
            tri9 = tri_data[pb[k_i], 0:9, l_i]
            ok[k_i, j_i, l_i] = inside_f64(sides_f64(origins[ray], dirs[ray], tri9),
                                           den[k_i, j_i, l_i])
        t = torch.where(ok, an / ad, torch.full_like(an, float("inf")))
        tmin, lane = t.min(dim=2)  # first minimum: smallest lane
        slot = (pb[:, None] * tb + lane).to(torch.int32).reshape(-1)
        ridx = (ps[:, None] * sub + lane_rays[None, :]).reshape(-1)
        tmin = tmin.reshape(-1)
        ct = torch.full((n_rays,), float("inf"), device=dev).scatter_reduce(
            0, ridx, tmin, "amin")
        eq = (tmin == ct[ridx]) & torch.isfinite(tmin)
        cs = torch.full((n_rays,), _INT32_MAX, dtype=torch.int32,
                        device=dev).scatter_reduce(0, ridx[eq], slot[eq], "amin")
        take = (ct < best_t) | ((ct == best_t) & (cs < best_s))
        best_t = torch.where(take, ct, best_t)
        best_s = torch.where(take, cs, best_s)
    t_out = torch.where(best_s >= 0, best_t, torch.full_like(best_t, float("inf")))
    return t_out, best_s


def intersect_pairs(p: dict):
    """Nearest hit of every ray over its subtile's pairs, for the walk keys
    of ``p`` (``prepare_pairs``' dict; see ``raycast_pairs_plain``):
    ``blocks[offsets[s]:offsets[s+1]]``, or every block where
    ``walk_all[s]`` is set (``walk_all`` may be None: no such subtile).  The
    kernel for CUDA tensors, its plain version for CPU tensors."""
    offsets, blocks = expand_walk_all(p["offsets"], p["blocks"], p["walk_all"],
                                      p["trif"].shape[0])
    w = {**p, "offsets": offsets, "blocks": blocks}
    f = p["f"]
    if f.device.type == "cuda":
        from ipcgen_tpu_torch.ops import _kernels

        return _kernels.raycast_pairs_cuda(w)
    if f.device.type == "cpu":
        return raycast_pairs_plain(w)
    raise ValueError(f"raycast_pairs: unsupported device {f.device}")


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def ray_sort_order(origins, dirs, lo, hi):
    """Coherence-restoring ray order: origin cell (4 bits per axis) then
    quantized direction (5-bit azimuth, 4-bit elevation)."""
    span = torch.clamp(hi - lo, min=1e-6)
    oc = torch.clamp(((origins - lo) / span * 16).to(torch.int32), 0, 15)
    ocell = (oc[:, 0] * 16 + oc[:, 1]) * 16 + oc[:, 2]
    az = torch.atan2(dirs[:, 1], dirs[:, 0])
    el = torch.asin(torch.clamp(dirs[:, 2], -1.0, 1.0))
    azb = torch.clamp(((az / math.pi + 1.0) * 16).to(torch.int32), 0, 31)
    elb = torch.clamp(((el / (math.pi / 2) + 1.0) * 8).to(torch.int32), 0, 15)
    key = ocell * 512 + azb * 16 + elb
    return torch.argsort(key, stable=True)


def prepare_pairs(origins, dirs, tri_data, block_lo, block_hi, *,
                  t_max: float = np.inf, sort_rays: bool = False):
    """Everything up to the pair walk: ray sort and padding, scene centering,
    panels, and the exact prepass.  Tiles are 2048 rays (1024 when sorted,
    as in ``raycast_mxu_components``), cut into 256-ray subtiles.

    Returns a dict with the walk's inputs (``f``, ``trif``, ``offsets``,
    ``blocks``, ``walk_all`` = None, ``t_init``, ``sub``, and for its float64
    edge test ``origins``, ``dirs``, ``tri_data`` and ``radius``), the
    bookkeeping
    (``n``, ``order``, ``overflow`` (T,) bool: the tiles JAX's caps would
    overflow), the prepass inputs (``origins``, ``dirs``: the rays sorted
    and padded, as the walk gets them) and its sizing (``tile``, ``group``, and JAX's caps
    ``gmax``, ``vmax``).
    """
    tile = 1024 if sort_rays else 2048
    n_sub = tile // SUB_MAX
    n = origins.shape[0]
    nb = tri_data.shape[0]
    t_init = float(t_max) if np.isfinite(t_max) else 1.0e30

    order = None
    if sort_rays:
        order = ray_sort_order(origins, dirs, _nanmin(block_lo, 0),
                               _nanmax(block_hi, 0))
        origins, dirs = origins[order], dirs[order]
    pad = (-n) % tile
    if pad:
        # Repeat the last ray: keeps the last tile's bundle tight.
        origins = torch.cat([origins, origins[-1:].expand(pad, 3)])
        dirs = torch.cat([dirs, dirs[-1:].expand(pad, 3)])

    center = (_nanmin(block_lo, 0) + _nanmax(block_hi, 0)) * 0.5
    trif = build_trif(tri_data, center)
    radius = block_radius(tri_data, center)
    # Prepass sizing as in raycast_mxu.py:1001-1030; gmax and vmax are JAX's
    # caps, used here only for its overflow predicate.
    group = 8 if nb <= 8192 else (16 if nb <= 32768 else 32)
    gmax = 96 if nb <= 2048 else (128 if nb <= 8192 else 192)
    vmax = min(768, nb)
    if sort_rays:
        gmax = min(-(-nb // group), 4 * gmax)
        vmax = min(1024, nb)
    offsets, blocks, groups, union = exact_prepass(
        origins, dirs, block_lo, block_hi, t_max=t_init, group=group, tile=tile,
        n_sub=n_sub)
    return dict(
        f=ray_features(origins - center, dirs), trif=trif, offsets=offsets,
        blocks=blocks, walk_all=None, t_init=t_init, sub=SUB_MAX, tri_data=tri_data,
        radius=radius, n=n,
        order=order, overflow=(groups > gmax) | (union > vmax),
        origins=origins, dirs=dirs, tile=tile, group=group, gmax=gmax, vmax=vmax,
    )


def overflow_frac(p: dict) -> float:
    """The share of tiles that JAX's caps would overflow (a host read)."""
    return float(p["overflow"].float().mean())


def raycast_pairs_components(origins, dirs, tri_data, block_lo, block_hi, *,
                             t_max: float = np.inf, sort_rays="auto"):
    """Candidate-pair raycast over raw asset components; returns
    (t (R,) +inf on miss, packed slot (R,) int32, -1 on miss).

    ``sort_rays="auto"`` re-runs with the coherence sort when more than 2 %
    of the tiles overflow JAX's caps (incoherent ray sets, whose unsorted
    tiles carry long lists), as ``raycast_mxu_components`` decides.
    """
    origins = origins.float().contiguous()
    dirs = dirs.float().contiguous()
    auto_sort = sort_rays == "auto"
    p = prepare_pairs(origins, dirs, tri_data, block_lo, block_hi, t_max=t_max,
                      sort_rays=bool(sort_rays) and not auto_sort)
    if auto_sort and overflow_frac(p) > 0.02:
        return raycast_pairs_components(
            origins, dirs, tri_data, block_lo, block_hi, t_max=t_max,
            sort_rays=True,
        )
    t, slot = intersect_pairs(p)
    n, order = p["n"], p["order"]
    t, slot = t[:n], slot[:n]
    if order is not None:
        t = torch.empty_like(t).index_put_((order,), t)
        slot = torch.empty_like(slot).index_put_((order,), slot)
    return t, slot


def raycast_asset_pairs(origins, dirs, asset: SceneAsset, t_max: float = np.inf,
                        sort_rays="auto") -> RaycastResult:
    """Intersect rays with the resident scene through the pair kernel."""
    origins = origins.float()
    dirs = dirs.float()
    t, slot = raycast_pairs_components(
        origins, dirs, asset.tri_data, asset.block_lo, asset.block_hi,
        t_max=t_max, sort_rays=sort_rays,
    )
    return finalize_result(origins, dirs, t, slot, asset)
