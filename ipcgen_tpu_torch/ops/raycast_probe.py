"""The pair raycast's probe variants: inputs, dispatch, and the kernels' plain
PyTorch versions.

Port of the three Pallas kernels of ``scripts/kernel_probe.py``, the JAX
package's tool for splitting the pair kernel's time into load, product and
epilogue floors: ``call`` (``make_kernel`` / ``make_quad_kernel``, a per-tile
walk of the candidate list in one of ``MODES``), ``grid_call`` (the walk as a
(tile x cap) grid with skipped steps) and ``flat_call`` (the walk over a flat
list of real (tile, block) pairs).  The CUDA kernels are in
``csrc/raycast_probe.cu``, launched through ``ops/_kernels.py``; the
functions ending in ``_plain`` below compute the same in torch ops and run
for CPU tensors (and in ``chip_smoke.py`` beside the kernels).

What a walk computes: rays come in tiles of ``TILE`` = 1024.  For each ray
and each triangle of a walked block, the five Pluecker products of the
port's float32 panel (``raycast_pairs.build_trif``, (NB, 10, 5*TB)) give
three edge sides, t_num and t_den.  A candidate counts when the side signs
agree, t = t_num / t_den > 1e-6 and |t_den| > 1e-9 (flat: the same guards
on the bit patterns, ``kernel_probe.py:508-510``).  The result is the
smallest (t, packed slot) pair, slot = block * TB + lane; a miss returns
t = t_init and slot -1, not +inf.  The ``bf16`` mode keeps the TPU's 3-term
split instead: bf16 hi/lo panels (``bf16_panels``) and features, products
f_hi*t_hi + f_hi*t_lo + f_lo*t_hi summed in float32.

The floor modes compute what the kernel's floors compute, so each is held
to its plain version bit for bit:

- ``dmaonly``, ``dmaonly4``: t = the bit-minimum (as int32, from the bits
  of t_init) over the walked blocks of coefficient row ``r // 256`` at lane
  ``r % 128`` of the panel, for ray ``r`` of its tile; slot -1;
- ``smallcarry4``: the same of coefficient row 0 for every ray; slot 0;
- ``matmul``, ``quadfloor``: all five products in the kernel's FMA order;
  t = the bit-minimum of the s0 column, slot = the bit-minimum of the other
  four columns (from INT32_MAX);
- ``nodma``: the full walk with block 0's panel standing for every walked
  block (the slots keep the walked block ids).
"""

from __future__ import annotations

import numpy as np
import torch

from ipcgen_tpu_torch.ops.raycast_pairs import (
    _nanmax,
    _nanmin,
    build_trif,
    candidate_blocks,
    ray_features,
)

TILE = 1024  # rays per tile
TB = 128  # triangles (lanes) per leaf block
THREADS = 256  # the kernel's threads per CUDA block (rays r, r + 256, ... share one)
VMAX = 256  # candidate-list width of the probe's prepass
T_INIT = 25.0  # the probe's t_max
# call's modes, in the kernel's order (``enum Mode`` of csrc/raycast_probe.cu).
MODES = ("full", "full4", "recip", "recip4", "bf16", "quad", "dmaonly",
         "dmaonly4", "matmul", "quadfloor", "smallcarry4", "nodma")
RESULT_MODES = ("full", "full4", "recip", "recip4", "bf16", "quad")
FLOOR_MODES = ("dmaonly", "dmaonly4", "matmul", "quadfloor", "smallcarry4")
# Modes whose per-ray result is a (t, slot) hit: the kernel merges their
# work items by a 64-bit minimum of (t bits << 32) | slot.
PACKED_MODES = RESULT_MODES + ("nodma",)
ITEM_PANELS = 8  # call's panels per work item (kItemPanels of the .cu)
EPS_T_BITS = int(np.float32(1e-6).view(np.int32))  # t > 1e-6, flat's int domain
EPS_DEN_BITS = int(np.float32(1e-9).view(np.int32))  # |t_den| > 1e-9
_INT32_MAX = 2**31 - 1
# Feature rows (d 0-2, m 3-5, o 6-8, 1 at 9) and panel (row, column group)
# of the 25 non-zero coefficients, in the kernel's order (coef_source).
_COEF_SOURCE = ([(j % 6, j // 6) for j in range(18)]
                + [(6 + j, 3) for j in range(4)] + [(j, 4) for j in range(3)])


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32)


def _key_const(t: float) -> int:
    return int(np.float32(t).view(np.int32))


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------
def bf16_panels(trif: torch.Tensor) -> torch.Tensor:
    """(NB, 10, W) float32 panels -> (NB, 20, W) bfloat16: rows 0-9 the hi
    part bf16(x), rows 10-19 the lo part bf16(x - hi)."""
    hi = trif.to(torch.bfloat16)
    lo = (trif - hi.float()).to(torch.bfloat16)
    return torch.cat([hi, lo], dim=1).contiguous()


def prepare_probe(origins, dirs, tri_data, block_lo, block_hi, *, gmax: int = 48):
    """The probe's inputs (``kernel_probe.py:288-307``): scene centre,
    panels, the candidate prepass over 1024-ray tiles (t_max ``T_INIT``,
    ``VMAX`` candidates, ``gmax`` block groups) and the ray features.

    ``origins``/``dirs`` (R, 3) with R a multiple of ``TILE``.  Returns a
    dict: ``f`` (R, 10), ``trif`` (NB, 10, 640), ``trif_bf16`` (NB, 20, 640),
    ``ids`` (V, T), ``counts`` (T,), ``ovf`` (T,) int32, ``n_tiles``, ``nb``.
    """
    n = origins.shape[0]
    if n == 0 or n % TILE:
        raise ValueError(f"{n} rays are not whole {TILE}-ray tiles")
    center = (_nanmin(block_lo, 0) + _nanmax(block_hi, 0)) * 0.5
    trif = build_trif(tri_data, center)
    ids, counts, ovf, _masks = candidate_blocks(
        origins, dirs, block_lo, block_hi, t_max=T_INIT, vmax=VMAX,
        gmax=gmax, tile=TILE)
    return dict(
        f=ray_features(origins - center, dirs), trif=trif,
        trif_bf16=bf16_panels(trif), ids=ids, counts=counts,
        ovf=ovf.to(torch.int32), n_tiles=n // TILE, nb=tri_data.shape[0],
        t_init=T_INIT,
    )


def walk_trips(counts: torch.Tensor, ovf: torch.Tensor, nb: int, vmax: int = VMAX):
    """The panels each tile's ``call`` walk covers: ``nb`` when it
    overflowed, else min(counts, vmax).  (T,) int32."""
    return torch.where(ovf != 0, nb, torch.clamp(counts, max=vmax)).to(torch.int32)


def item_offsets(counts: torch.Tensor, ovf: torch.Tensor, nb: int, vmax: int = VMAX,
                 k: int = ITEM_PANELS) -> torch.Tensor:
    """``call``'s work items per tile, scanned: tile t walks its trip
    (``walk_trips``) in ceil(trip / k) items, numbered offsets[t] ..
    offsets[t+1] - 1.  (T+1,) int32, on the inputs' device; no host read."""
    trips = walk_trips(counts, ovf, nb, vmax)
    offsets = torch.zeros(counts.shape[0] + 1, dtype=torch.int32, device=counts.device)
    offsets[1:] = torch.cumsum((trips + k - 1) // k, 0)
    return offsets


def probe_items(counts: torch.Tensor, ovf: torch.Tensor, nb: int, k: int = ITEM_PANELS,
                vmax: int = VMAX):
    """The kernel's schedule (``probe_call_kernel``): item i walks list
    positions starts[i] .. stops[i] - 1 of tile tiles[i], at most ``k`` of
    them; a tile's items are consecutive and in list order.  Returns
    (offsets (T+1,) as ``item_offsets``, tiles, starts, stops (I,) int64)."""
    offsets = item_offsets(counts, ovf, nb, vmax, k)
    per_tile = (offsets[1:] - offsets[:-1]).long()
    tiles = torch.repeat_interleave(torch.arange(counts.shape[0], device=counts.device),
                                    per_tile)
    trips = walk_trips(counts, ovf, nb, vmax).long()
    starts = (torch.arange(tiles.numel(), device=counts.device) - offsets[tiles]) * k
    return offsets, tiles, starts, torch.minimum(starts + k, trips[tiles])


def grid_ids(ids: torch.Tensor, counts: torch.Tensor, cap: int):
    """``grid_call``'s inputs (``kernel_probe.py:446-454``): the first
    ``cap`` candidates of each tile, the last one repeated past its count,
    flattened tile-major, and the counts clamped to ``cap``."""
    if not 0 < cap <= ids.shape[0]:
        raise ValueError(f"cap {cap} must be in 1..{ids.shape[0]} (the list width)")
    v = torch.arange(cap, device=ids.device)[None, :]
    sel = torch.minimum(v, torch.clamp(counts[:, None].long() - 1, min=0))
    flat = torch.gather(ids.T[:, :cap], 1, sel).reshape(-1)
    return (flat.to(torch.int32).contiguous(),
            torch.clamp(counts, max=cap).to(torch.int32).contiguous())


def flat_pairs(ids: torch.Tensor, counts: torch.Tensor, ovf: torch.Tensor, nb: int):
    """``flat_call``'s pair list (``kernel_probe.py:594-611``, without the
    padding and the sentinel): each tile's candidate list in order, every
    block for an overflowed tile; (pair_tiles, pair_blocks) int32, tiles
    ascending.  These are also the pairs ``call`` walks."""
    vmax, n_tiles = ids.shape
    dev = ids.device
    j = torch.arange(vmax, device=dev)[:, None]
    live = (j < counts[None, :]) & (ovf[None, :] == 0)  # (V, T)
    lt, lj = live.T.nonzero(as_tuple=True)  # tile-major, list order
    tiles, blocks = [lt], [ids[lj, lt].long()]
    over = (ovf != 0).nonzero().flatten()
    if over.numel():
        tiles.append(over.repeat_interleave(nb))
        blocks.append(torch.arange(nb, device=dev).repeat(over.numel()))
    pt, pb = torch.cat(tiles), torch.cat(blocks)
    order = torch.argsort(pt, stable=True)
    return (pt[order].to(torch.int32).contiguous(),
            pb[order].to(torch.int32).contiguous())


def grid_pairs(ids_flat: torch.Tensor, counts: torch.Tensor, cap: int):
    """The (tile, block) pairs ``grid_call`` runs: step v < counts[tile]."""
    n_tiles = counts.shape[0]
    live = torch.arange(cap, device=counts.device)[None, :] < counts[:, None]
    lt, lv = live.nonzero(as_tuple=True)
    return (lt.to(torch.int32),
            ids_flat.view(n_tiles, cap)[lt, lv].to(torch.int32))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------
def _fma(a, b, c):
    """float32 fused multiply-add, rounded once (through float64, where
    a * b is exact)."""
    return (a.double() * b.double() + c.double()).float()


def _fma_products(x, c):
    """The kernel's five products in its FMA order (``products`` in the
    .cu).  x (k, 1024, 1, 9) features, c: 25 coefficient tensors
    (k, 1, TB)."""
    def dot6(off):
        a = x[..., 0] * c[off]
        for j in range(1, 6):
            a = _fma(x[..., j], c[off + j], a)
        return a

    num = _fma(x[..., 8], c[20], _fma(x[..., 7], c[19], _fma(x[..., 6], c[18], c[21])))
    den = _fma(x[..., 2], c[24], _fma(x[..., 1], c[23], x[..., 0] * c[22]))
    return dot6(0), dot6(6), dot6(12), num, den


def _coefs(panels: torch.Tensor):
    """(k, 10, 5*TB) panels -> the 25 non-zero coefficient rows, (k, 1, TB)
    each."""
    return [panels[:, row, grp * TB:(grp + 1) * TB][:, None, :]
            for row, grp in _COEF_SOURCE]


def _walk_plain(f, n_tiles: int, pair_tile, pair_block, trif, mode: str,
                t_init: float):
    """Every walk's plain version over explicit (tile, block) pairs."""
    dev = f.device
    n = n_tiles * TILE
    init_key = _key_const(t_init)
    pt, pb = pair_tile.long(), pair_block.long()
    feats = f.view(n_tiles, TILE, 10)
    ray_in_tile = torch.arange(TILE, device=dev)
    if mode in ("dmaonly", "dmaonly4", "smallcarry4"):
        row = (ray_in_tile // THREADS if mode != "smallcarry4"
               else torch.zeros_like(ray_in_tile))
        vals = _bits(trif[pb[:, None], row[None, :], (ray_in_tile % TB)[None, :]])
        key = torch.full((n,), init_key, dtype=torch.int32, device=dev)
        ridx = (pt[:, None] * TILE + ray_in_tile).reshape(-1)
        key = key.scatter_reduce(0, ridx, vals.reshape(-1), "amin")
        slot = torch.full((n,), 0 if mode == "smallcarry4" else -1,
                          dtype=torch.int32, device=dev)
        return key.view(torch.float32), slot

    chunk_elems = (1 << 26) if dev.type == "cuda" else (1 << 21)
    chunk = max(1, chunk_elems // (TILE * 5 * TB))
    if mode in ("matmul", "quadfloor"):
        k_t = torch.full((n,), init_key, dtype=torch.int32, device=dev)
        k_s = torch.full((n,), _INT32_MAX, dtype=torch.int32, device=dev)
        for s in range(0, pt.numel(), chunk):
            cpt, cpb = pt[s:s + chunk], pb[s:s + chunk]
            x = feats[cpt][:, :, None, :9]
            s0, s1, s2, num, den = _fma_products(x, _coefs(trif[cpb]))
            other = torch.minimum(torch.minimum(_bits(s1), _bits(s2)),
                                  torch.minimum(_bits(num), _bits(den)))
            ridx = (cpt[:, None] * TILE + ray_in_tile).reshape(-1)
            k_t = k_t.scatter_reduce(0, ridx, _bits(s0).amin(dim=2).reshape(-1), "amin")
            k_s = k_s.scatter_reduce(0, ridx, other.amin(dim=2).reshape(-1), "amin")
        return k_t.view(torch.float32), k_s

    # Result modes (and nodma): the lexicographic minimum of (t bits, slot)
    # as one int64 (t > 0, so its bits are positive).
    miss = (init_key << 32) | 0xFFFFFFFF
    best = torch.full((n,), miss, dtype=torch.int64, device=dev)
    lane = torch.arange(TB, device=dev)
    for s in range(0, pt.numel(), chunk):
        cpt, cpb = pt[s:s + chunk], pb[s:s + chunk]
        x = feats[cpt]  # (k, 1024, 10)
        if mode == "bf16":
            xh = x.to(torch.bfloat16).float()
            xl = (x - xh).to(torch.bfloat16).float()
            panels = trif[cpb].float()
            th, tl = panels[:, :10], panels[:, 10:]
            g = torch.bmm(xh, th) + torch.bmm(xh, tl) + torch.bmm(xl, th)
        else:
            panels = trif[torch.zeros_like(cpb)] if mode == "nodma" else trif[cpb]
            g = torch.bmm(x, panels)  # (k, 1024, 5*TB)
        s0, s1, s2, num, den = g.split(TB, dim=2)
        i0, i1, i2 = _bits(s0), _bits(s1), _bits(s2)
        ok = ((i0 ^ i1) | (i0 ^ i2)) >= 0
        t = num / den
        if mode == "flat":
            tb_i = _bits(t)
            ok = ok & (tb_i > EPS_T_BITS) & ((_bits(den) & _INT32_MAX) > EPS_DEN_BITS)
        else:
            ok = ok & (t > 1e-6) & (den.abs() > 1e-9)
        key = _bits(t).long()
        slot = (cpb[:, None, None] * TB + lane).expand_as(key)
        packed = torch.where(ok & (key < init_key), (key << 32) | slot,
                             torch.full_like(key, miss))
        ridx = (cpt[:, None] * TILE + ray_in_tile).reshape(-1)
        best = best.scatter_reduce(0, ridx, packed.amin(dim=2).reshape(-1), "amin")
    hit = best != miss
    t_out = torch.where(hit, (best >> 32).to(torch.int32).view(torch.float32),
                        torch.full((n,), float(t_init), device=dev))
    slot_out = torch.where(hit, (best & 0xFFFFFFFF).to(torch.int32),
                           torch.full((n,), -1, dtype=torch.int32, device=dev))
    return t_out, slot_out


def probe_call_plain(f, ids, counts, ovf, trif, mode: str, t_init: float = T_INIT):
    """``probe_call_kernel``'s function in ``mode``: each tile walks its
    candidate list (every block when overflowed).  ``trif`` is the bf16
    (NB, 20, 640) panel for mode "bf16", else the float32 one.  Returns
    (t (T*1024,) float32, slot (T*1024,) int32)."""
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}; expected one of {MODES}")
    pt, pb = flat_pairs(ids, counts, ovf, trif.shape[0])
    return _walk_plain(f, counts.shape[0], pt, pb, trif, mode, t_init)


def probe_grid_plain(f, ids_flat, counts, trif, cap: int, t_init: float = T_INIT):
    """``probe_grid_kernel``'s function: each tile walks steps
    v < counts[tile] of its ``cap`` ids; returns (t, slot)."""
    pt, pb = grid_pairs(ids_flat, counts, cap)
    return _walk_plain(f, counts.shape[0], pt, pb, trif, "full", t_init)


def probe_flat_plain(f, pair_tiles, pair_blocks, n_tiles: int, trif,
                     t_init: float = T_INIT):
    """``probe_flat_kernel``'s function: the walk over the flat pair list with
    the guards on bit patterns; returns (t, slot)."""
    return _walk_plain(f, n_tiles, pair_tiles, pair_blocks, trif, "flat", t_init)


def agreement(t_a, s_a, t_b, s_b) -> dict:
    """How result a agrees with result b: the share of rays with the same
    slot, the largest relative and absolute t difference where both hit the
    same slot, and whether the two are equal bit for bit."""
    same = s_a == s_b
    hit = same & (s_a >= 0)
    diff = (t_a - t_b).abs()[hit]
    rel = diff / t_b.abs()[hit].clamp(min=1e-12)
    return dict(
        same_slot=float(same.float().mean()),
        max_rel=float(rel.max()) if rel.numel() else 0.0,
        max_abs=float(diff.max()) if diff.numel() else 0.0,
        bits_equal=bool(torch.equal(t_a.view(torch.int32), t_b.view(torch.int32))
                        and torch.equal(s_a, s_b)),
    )


# ---------------------------------------------------------------------------
# Dispatch: the kernel for CUDA tensors, the plain version for CPU tensors
# ---------------------------------------------------------------------------
def _route(f):
    if f.device.type == "cuda":
        from ipcgen_tpu_torch.ops import _kernels

        return _kernels
    if f.device.type == "cpu":
        return None
    raise ValueError(f"raycast_probe: unsupported device {f.device}")


def probe_call(f, ids, counts, ovf, trif, mode: str, t_init: float = T_INIT):
    kernels = _route(f)
    if kernels is None:
        return probe_call_plain(f, ids, counts, ovf, trif, mode, t_init)
    return kernels.raycast_probe_call_cuda(f, ids, counts, ovf, trif, mode, t_init)


def probe_grid(f, ids_flat, counts, trif, cap: int, t_init: float = T_INIT):
    kernels = _route(f)
    if kernels is None:
        return probe_grid_plain(f, ids_flat, counts, trif, cap, t_init)
    return kernels.raycast_probe_grid_cuda(f, ids_flat, counts, trif, cap, t_init)


def probe_flat(f, pair_tiles, pair_blocks, n_tiles: int, trif, t_init: float = T_INIT):
    kernels = _route(f)
    if kernels is None:
        return probe_flat_plain(f, pair_tiles, pair_blocks, n_tiles, trif, t_init)
    return kernels.raycast_probe_flat_cuda(f, pair_tiles, pair_blocks, n_tiles,
                                           trif, t_init)
