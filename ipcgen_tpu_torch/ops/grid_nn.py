"""Grid-hashed neighbour searches: the persistent slab grid of the label
transfer, and the CSR grid's 1-NN and k-NN.

Port of ``ipcgen_tpu/ops/grid_nn.py`` in torch ops: ``LabelGrid`` (:450-586)
and its core ``_slab_nn_core`` (:335-405); ``nearest_neighbor_indices_grid``
(:206-318) and ``knn_grid`` (:639-705) with their cores ``_grid_nn_core``
(:71-136) and ``_grid_knn_core`` (:588-636).  The host-side builds
(``_choose_cell_size`` :148-173, ``_build_hash_grid`` :176-203,
``_build_slab_host`` :408-447) are copied, because that module imports jax
at its top.

Reference points are bucketed by a hash of their grid cell; a query gathers
the 2x2x2 cells nearest to it.  The slab grid stores each bucket as a dense
(cap, 3) block, the CSR grid as a run of the bucket-sorted points.

Slab grid: an answer is accepted only when provably nearest, found within
the query's margin to the searched window with no visited bucket truncated.
Level 0 uses cell h, level 1 cell 4h with a wider cap, and the residue goes
to the exact 1-NN (``ops/knn.py``, on the card its kernel) against the grid's
own device copy of the references, so the returned index is always the true
nearest neighbour.

CSR 1-NN: the same acceptance at the fixed radius h/2, a retry at doubled
cell size (twice at most), then the exact 1-NN.  CSR k-NN: the k nearest of
the window's candidates, approximate by design (buckets beyond ``cap`` are
truncated); a query with fewer than k finite candidates keeps +inf.

The JAX package pads the query rows to bucketed lengths only so that its
compiled programs are shared between rooms; padded rows are sliced off and
never change a result, so the port searches the rows it is given.  Ties
resolve as ``jax.lax.top_k`` and ``argmin`` resolve them there: to the first
candidate position (the window offset, then the slot in the bucket).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ipcgen_tpu_torch.ops.knn import (
    nearest_neighbor_indices,
    nearest_neighbor_tensor,
    select_smallest,
)
from ipcgen_tpu_torch.utils.device import device_or_card, sync, upload
from ipcgen_tpu_torch.utils.profiling import Recorder

# Spatial-hash primes; the hash wraps in uint32 identically on host and device.
_P1, _P2, _P3 = 73856093, 19349663, 83492791
_MAX_TABLE = 1 << 22  # 4M buckets: the starts table stays <= 16 MB int32
# Candidates gathered per chunk of queries: the chunk has
# max(q_block, _CHUNK_CANDIDATES // (8 * cap)) rows.
_CHUNK_CANDIDATES = 1 << 24


def _bucket_len(n: int, granularity: int = 4, minimum: int = 16) -> int:
    """The JAX package's bucketed length for ``n`` rows (kept for callers that
    size buffers as it does; the port's searches take any length)."""
    if n <= minimum:
        return minimum
    step = 1 << max((n - 1).bit_length() - granularity.bit_length() + 1, 0)
    return -(-n // step) * step


def _occupancy_counts(refs: np.ndarray, lo: np.ndarray, h: float) -> np.ndarray:
    cells = np.floor((refs - lo) / h).astype(np.int64)
    lin = cells[:, 0] * _P1 ^ cells[:, 1] * _P2 ^ cells[:, 2] * _P3
    _, counts = np.unique(lin, return_counts=True)
    return counts


def _cell_hash(cell_of) -> torch.Tensor:
    """The int64 spatial hash of the cells ``cell_of(axis)`` gives, an axis
    at a time so that no (N, 3) cell array is held; its low 32 bits are the
    uint32 hash's."""
    return (cell_of(0) * _P1) ^ (cell_of(1) * _P2) ^ (cell_of(2) * _P3)


def _occupancy_counts_tensor(refs: torch.Tensor, lo: torch.Tensor, h: float) -> np.ndarray:
    """``_occupancy_counts`` of references on their device, sorted.  Only
    the histogram of the counts comes back; the counts' mean and
    percentile depend on their multiset alone."""
    # A device scalar: torch divides by a host scalar through its reciprocal.
    h_t = torch.tensor(h, dtype=torch.float32, device=refs.device)
    lin = _cell_hash(lambda c: torch.floor((refs[:, c] - lo[c]) / h_t).long())
    hist = torch.bincount(torch.unique(lin, return_counts=True)[1]).cpu().numpy()
    return np.repeat(np.arange(len(hist), dtype=np.int64), hist)


def _choose_cell_size(refs: np.ndarray, cap: int) -> float:
    """Cell size targeting ~cap/4 refs per occupied cell AND p99 <= cap."""
    lo = refs.min(axis=0)
    extent = np.maximum(refs.max(axis=0) - lo, 1e-6)
    return _shrink_cell_size(extent, len(refs), cap,
                             lambda h: _occupancy_counts(refs, lo, h))


def _shrink_cell_size(extent: np.ndarray, n: int, cap: int, counts_at) -> float:
    """``_choose_cell_size``'s rule over ``counts_at(h)``, the occupied
    cells' counts at cell size ``h``."""
    h = float(max(np.cbrt(extent.prod() / max(n, 1)) * 4.0, 0.02))
    for _ in range(6):
        counts = counts_at(h)
        mean_occ = counts.mean()
        p99 = float(np.percentile(counts, 99))
        if mean_occ <= cap / 2.0 and p99 <= cap:
            break
        shrink = 1.0  # surface clouds: occupancy scales ~h^2
        if mean_occ > cap / 2.0:
            shrink = min(shrink, float(np.sqrt((cap / 4.0) / mean_occ)))
        if p99 > cap:
            shrink = min(shrink, float(np.sqrt(cap / p99)))
        h = max(h * shrink, 0.01)
        if h == 0.01:
            break
    return h


def _build_slab_host(refs: np.ndarray, cell_size: float, cap: int, t_bits: int):
    """(table (T,cap,3), counts (T,), slot_ids (T*cap,), lo, inv_h, dims).
    Rows beyond ``cap`` per bucket are dropped; their buckets keep the TRUE
    count so queries there are flagged as overflowed."""
    lo = refs.min(axis=0)
    extent = np.maximum(refs.max(axis=0) - lo, 1e-6)
    inv_h = 1.0 / cell_size
    dims = np.maximum(np.ceil(extent * inv_h).astype(np.int64) + 1, 1)
    cells = np.clip(np.floor((refs - lo) * inv_h).astype(np.int64), 0, dims - 1)
    t_size = 1 << t_bits
    cu = cells.astype(np.uint32)
    bucket = (
        (cu[:, 0] * np.uint32(_P1))
        ^ (cu[:, 1] * np.uint32(_P2))
        ^ (cu[:, 2] * np.uint32(_P3))
    ) & np.uint32(t_size - 1)
    order = np.argsort(bucket, kind="stable")
    counts = np.bincount(bucket.astype(np.int64), minlength=t_size)
    starts = np.zeros(t_size + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    slot_in_bucket = np.arange(len(refs)) - starts[bucket.astype(np.int64)][order]
    keep = slot_in_bucket < cap
    flat = bucket.astype(np.int64)[order][keep] * cap + slot_in_bucket[keep]
    table = np.full((t_size * cap, 3), 1e7, np.float32)
    table[flat] = refs[order][keep]
    slot_ids = np.zeros(t_size * cap, np.int32)
    slot_ids[flat] = order[keep].astype(np.int32)
    return (
        table.reshape(t_size, cap, 3),
        np.minimum(counts, 2**31 - 1).astype(np.int32),
        slot_ids,
        lo.astype(np.float32),
        float(inv_h),
        dims,
    )


def _bounds_tensor(refs: torch.Tensor):
    """(lo on the device, extent on the host): ``_build_slab_host``'s
    bounds, the extent computed by the same numpy expression."""
    lo_t = refs.amin(dim=0)
    return lo_t, np.maximum(refs.amax(dim=0).cpu().numpy() - lo_t.cpu().numpy(), 1e-6)


def _build_slab_tensor(refs: torch.Tensor, lo_t: torch.Tensor, extent: np.ndarray,
                       cell_size: float, cap: int, t_bits: int):
    """``_build_slab_host`` with torch ops on the references' device: the
    same uint32 bucket hash (its low bits agree in int64), a stable sort by
    bucket, the true counts and the 1e7 fill, so table, counts and slot ids
    are bit for bit the host build's.  Returns its tuple with tensors for
    the tables and ``lo``."""
    device = refs.device
    inv_h = 1.0 / cell_size
    dims = np.maximum(np.ceil(extent * inv_h).astype(np.int64) + 1, 1)
    # numpy multiplies float32 rows by float32(inv_h); so does a float32 tensor.
    inv_h_t = torch.tensor(inv_h, dtype=torch.float32, device=device)
    t_size = 1 << t_bits
    bucket = _cell_hash(lambda c: torch.floor((refs[:, c] - lo_t[c]) * inv_h_t).long()
                        .clamp_(0, int(dims[c]) - 1)) & (t_size - 1)
    counts = torch.bincount(bucket, minlength=t_size)
    b_sorted, order = torch.sort(bucket, stable=True)
    del bucket  # each temporary goes before the tables are allocated
    slot = torch.arange(len(refs), device=device).sub_((torch.cumsum(counts, 0) - counts)[b_sorted])
    keep = slot < cap
    flat = b_sorted.mul_(cap).add_(slot)[keep]
    kept = order[keep]
    del b_sorted, order, slot, keep
    table = torch.full((t_size * cap, 3), 1e7, dtype=torch.float32, device=device)
    table[flat] = refs[kept]
    slot_ids = torch.zeros(t_size * cap, dtype=torch.int32, device=device)
    slot_ids[flat] = kept.int()
    return (
        table.view(t_size, cap, 3),
        counts.clamp_(max=2**31 - 1).int(),
        slot_ids,
        lo_t,
        float(inv_h),
        dims,
    )


def builds_on_card(device) -> bool:
    """Whether ``LabelGrid`` builds its levels on ``device`` with torch ops
    (a CUDA device); elsewhere numpy builds them on the host."""
    return torch.device(device).type == "cuda"


_OFFS = [[ox, oy, oz] for ox in (0, 1) for oy in (0, 1) for oz in (0, 1)]


def _slab_nn_core(q, table, counts, slot_ids, lo, inv_h, dims, cap: int):
    """Provably exact 1-NN ids (into the ORIGINAL ref order) for one chunk of
    (B, 3) queries, -1 where the hashed answer is not provably exact.

    Acceptance uses the per-query margin to the boundary of the 2-cell window
    searched on each axis (in [0.5h, 1h]): any point strictly closer than
    that lies inside the window, so a hit within it cannot be beaten.
    """
    t_size = counts.shape[0]
    offs = torch.tensor(_OFFS, dtype=torch.int32, device=q.device)
    gpos = (q - lo) * inv_h  # grid units
    base = torch.floor(gpos - 0.5).to(torch.int32)
    frac = gpos - base.float()
    margin = torch.minimum(frac, 2.0 - frac).amin(dim=-1)
    r_acc = (margin - 1e-3) / inv_h
    c = base[:, None, :] + offs[None, :, :]  # (B, 8, 3)
    in_grid = ((c >= 0) & (c < dims)).all(dim=-1)  # (B, 8)
    cl = c.long()
    # uint32 wrap-around hash: the low bits of the int64 products agree.
    cid = ((cl[..., 0] * _P1) ^ (cl[..., 1] * _P2) ^ (cl[..., 2] * _P3)) & (t_size - 1)
    cnt = counts[cid]
    ovf = (in_grid & (cnt > cap)).any(dim=1)
    cand = table[cid]  # (B, 8, cap, 3)
    nvalid = torch.clamp(cnt, max=cap)
    valid = (torch.arange(cap, device=q.device)[None, None, :] < nvalid[..., None]) \
        & in_grid[..., None]
    d2 = ((q[:, None, None, :] - cand) ** 2).sum(-1)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    d2 = d2.reshape(q.shape[0], 8 * cap)
    slot = (cid[..., None] * cap + torch.arange(cap, device=q.device)).reshape(
        q.shape[0], 8 * cap)
    bd, best = torch.min(d2, dim=1)
    bslot = slot.gather(1, best[:, None])[:, 0]
    bi = slot_ids[bslot]
    exact = (bd <= r_acc * r_acc) & ~ovf
    return torch.where(exact, bi, torch.full_like(bi, -1))


class LabelGrid:
    """Persistent two-level slab grid for exact 1-NN label transfer.

    Built once per room (in the label prefetch thread) and queried per
    transfer.  Levels: L0 cell h, cap 24; L1 cell 4h, cap 384; residue: the
    exact 1-NN against ``refs_dev``.  Tables and ``refs_dev``, one copy of
    the references, live on ``device``.

    The build follows the device alone (``builds_on_card``): on a CUDA
    device the references go up once, as ``refs_dev``, and the cell size
    and both levels are built there with torch ops (``_build_slab_tensor``);
    elsewhere numpy builds them (``_build_slab_host``) and the tables go up.
    Both builds give the same ``h0``, tables, counts and slot ids;
    ``device_build`` says which one ran.
    """

    Q_BLOCK = 32768
    Q_BLOCK_L1 = 8192

    def __init__(self, refs: np.ndarray, cap0: int = 24, cap1: int = 384,
                 device="cuda"):
        refs = np.asarray(refs, dtype=np.float32)
        self.n_refs = len(refs)
        self.device = torch.device(device)
        self.device_build = builds_on_card(self.device)
        if self.n_refs == 0:
            return
        t_bits0 = min(max(int(2 * self.n_refs - 1).bit_length(), 10), 18)
        t_bits1 = min(max(t_bits0 - 4, 10), 14)
        caps = (cap0, cap1)

        def levels(h0):  # (cell size, cap, table bits) of L0 and L1
            return zip((h0, 4.0 * h0), caps, (t_bits0, t_bits1))

        if self.device_build:
            refs_t = self.refs_dev = upload(refs, self.device)
            lo_t, extent = _bounds_tensor(refs_t)
            self.h0 = _shrink_cell_size(extent, self.n_refs, cap0,
                                        lambda h: _occupancy_counts_tensor(refs_t, lo_t, h))
            slabs = [_build_slab_tensor(refs_t, lo_t, extent, *lvl)
                     for lvl in levels(self.h0)]
        else:
            self.h0 = _choose_cell_size(refs, cap0)
            slabs = [_build_slab_host(refs, *lvl) for lvl in levels(self.h0)]
            self.refs_dev = torch.from_numpy(np.ascontiguousarray(refs)).to(self.device)
        # Host arrays go up here; tensors built on the device stay there.
        self._lvl = [dict(
            table=torch.as_tensor(tab).to(self.device),
            counts=torch.as_tensor(cnt).to(self.device),
            slot_ids=torch.as_tensor(sid).to(self.device),
            lo=torch.as_tensor(lo).to(self.device),
            inv_h=torch.tensor(invh, dtype=torch.float32, device=self.device),
            dims=torch.from_numpy(dims.astype(np.int32)).to(self.device),
            cap=int(cap),
        ) for (tab, cnt, sid, lo, invh, dims), cap in zip(slabs, caps)]

    def record_stream(self, stream) -> None:
        """Mark every tensor the queries read as used on ``stream``, so that
        the caching allocator keeps tensors built on another stream until
        ``stream``'s work on them is done."""
        if self.n_refs == 0:
            return
        for t in [self.refs_dev] + [v for p in self._lvl for v in p.values()
                                    if isinstance(v, torch.Tensor)]:
            t.record_stream(stream)

    def _run_level(self, q: torch.Tensor, lvl: int, q_block: int) -> torch.Tensor:
        p = self._lvl[lvl]
        out = [
            _slab_nn_core(q[s:s + q_block], p["table"], p["counts"],
                          p["slot_ids"], p["lo"], p["inv_h"], p["dims"], p["cap"])
            for s in range(0, q.shape[0], q_block)
        ]
        return torch.cat(out)

    def query(self, queries, rec: Optional[Recorder] = None) -> np.ndarray:
        """Exact 1-NN indices into the references for (N, 3) queries (tensor on any
        device, or array); returns (N,) int32 numpy.

        ``rec`` (a ``Recorder``) takes the seconds of each level,
        ``label_nn_l0``, ``label_nn_l1`` (where rows reached it) and
        ``label_nn_residue`` (the exact 1-NN, 0 without residue), and the
        rows queried and left to each: ``label_nn_query_rows``,
        ``label_nn_l1_rows``, ``label_nn_residue_rows``."""
        n = len(queries)
        if self.n_refs == 0:
            return np.zeros((n,), np.int32)
        if n == 0:
            return np.zeros((0,), np.int32)
        if rec is None:
            rec = Recorder()
        rec.count("label_nn_query_rows", n)
        with rec.span("label_nn_l0"):
            q = torch.as_tensor(queries, dtype=torch.float32).to(self.device)
            idx = self._run_level(q, 0, self.Q_BLOCK)
            unresolved = torch.nonzero(idx < 0).flatten()
        still = unresolved
        if unresolved.numel():
            with rec.span("label_nn_l1"):
                idx1 = self._run_level(q[unresolved], 1, self.Q_BLOCK_L1)
                idx[unresolved] = idx1
                still = unresolved[idx1 < 0]
        rec.count("label_nn_l1_rows", unresolved.numel())
        rec.count("label_nn_residue_rows", still.numel())
        if still.numel():
            with rec.span("label_nn_residue"):
                idx[still] = nearest_neighbor_tensor(q[still], self.refs_dev).to(idx.dtype)
                sync(self.device)  # the span times the search, not its launch
        else:
            rec.count("label_nn_residue", 0.0)
        return idx.cpu().numpy().astype(np.int32)


# ---------------------------------------------------------------------------
# CSR grid: 1-NN with a doubled-cell retry, and the k-NN of dense self-joins
# ---------------------------------------------------------------------------


def _build_hash_grid(
    refs: np.ndarray, cell_size: float
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, float]:
    """Bucket refs by hashed grid cell.

    Returns (order, starts(T+1) int32, lo, dims(3) int64, inv_h).  Table size
    T is a power of two ~2x the point count (capped at ``_MAX_TABLE``), so
    memory never scales with the scene's extent.
    """
    lo = refs.min(axis=0)
    extent = np.maximum(refs.max(axis=0) - lo, 1e-6)
    inv_h = 1.0 / cell_size
    dims = np.maximum(np.ceil(extent * inv_h).astype(np.int64) + 1, 1)
    cells = np.clip(np.floor((refs - lo) * inv_h).astype(np.int64), 0, dims - 1)

    t_size = 1 << max(int(2 * max(len(refs), 1) - 1).bit_length(), 10)
    t_size = min(t_size, _MAX_TABLE)
    cu = cells.astype(np.uint32)
    bucket = (
        (cu[:, 0] * np.uint32(_P1))
        ^ (cu[:, 1] * np.uint32(_P2))
        ^ (cu[:, 2] * np.uint32(_P3))
    ) & np.uint32(t_size - 1)
    order = np.argsort(bucket, kind="stable")
    counts = np.bincount(bucket.astype(np.int64), minlength=t_size)
    starts = np.zeros(t_size + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    return order, starts.astype(np.int32), lo, dims, inv_h


def _grid_tensors(refs: np.ndarray, cell_size: float, device: torch.device):
    """The CSR grid of ``refs`` on ``device``: (order, grid tensors for the
    cores: refs_sorted, starts, lo, inv_h, dims)."""
    order, starts, lo, dims, inv_h = _build_hash_grid(refs, cell_size)
    grid = (
        torch.from_numpy(refs[order]).to(device),
        torch.from_numpy(starts).to(device),
        torch.from_numpy(np.asarray(lo, np.float32)).to(device),
        torch.tensor(np.float32(inv_h), device=device),
        torch.from_numpy(dims.astype(np.int32)).to(device),
    )
    return order, grid


def _grid_candidates(q, refs_sorted, starts, lo, inv_h, dims, cap: int):
    """The candidates of (B, 3) queries in their 2x2x2 windows: (slot (B,
    8*cap) int64 into refs_sorted, d2 (B, 8*cap) with +inf for empty slots,
    ovf (B,) True where a visited bucket holds more than ``cap``)."""
    table_mask = starts.shape[0] - 2  # T - 1
    m = refs_sorted.shape[0]
    offs = torch.tensor(_OFFS, dtype=torch.int32, device=q.device)
    base = torch.floor((q - lo) * inv_h - 0.5).to(torch.int32)
    c = base[:, None, :] + offs[None, :, :]  # (B, 8, 3)
    in_grid = ((c >= 0) & (c < dims)).all(dim=-1)
    cl = c.long()
    # uint32 wrap-around hash: the low bits of the int64 products agree.
    cid = ((cl[..., 0] * _P1) ^ (cl[..., 1] * _P2) ^ (cl[..., 2] * _P3)) & table_mask
    s = starts[cid].long()
    e = starts[cid + 1].long()
    ovf = (in_grid & ((e - s) > cap)).any(dim=1)
    slot = s[..., None] + torch.arange(cap, device=q.device)  # (B, 8, cap)
    valid = (slot < e[..., None]) & in_grid[..., None]
    slot = slot.clamp(0, m - 1)
    cand = refs_sorted[slot]  # (B, 8, cap, 3)
    diff = q[:, None, None, :] - cand
    d2 = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] \
        + diff[..., 2] * diff[..., 2]
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    b = q.shape[0]
    return slot.reshape(b, 8 * cap), d2.reshape(b, 8 * cap), ovf


def _chunks(n: int, cap: int, q_block: int):
    rows = max(q_block, _CHUNK_CANDIDATES // (8 * cap))
    return range(0, n, rows), rows


def _grid_nn_core(queries, refs_sorted, starts, lo, inv_h, dims, cap: int,
                  q_block: int):
    """Nearest window candidate per query: (slot (N,) int64 into
    refs_sorted, d2 (N,), ovf (N,) bool).  Ties go to the first candidate
    position, as the JAX core's running argmin over the offsets gives."""
    out_i, out_d, out_o = [], [], []
    starts_at, rows = _chunks(queries.shape[0], cap, q_block)
    for s in starts_at:
        slot, d2, ovf = _grid_candidates(queries[s:s + rows], refs_sorted, starts,
                                         lo, inv_h, dims, cap)
        pos = torch.argmin(d2, dim=1, keepdim=True)
        out_i.append(slot.gather(1, pos)[:, 0])
        out_d.append(d2.gather(1, pos)[:, 0])
        out_o.append(ovf)
    return torch.cat(out_i), torch.cat(out_d), torch.cat(out_o)


def _grid_knn_core(queries, refs_sorted, starts, lo, inv_h, dims, cap: int,
                   k: int, q_block: int):
    """The k nearest window candidates per query, nearest first: (slot (N,
    k) int64 into refs_sorted, d2 (N, k)).  Ties go to the first candidate
    position, as ``jax.lax.top_k`` gives."""
    out_i, out_d = [], []
    starts_at, rows = _chunks(queries.shape[0], cap, q_block)
    for s in starts_at:
        slot, d2, _ = _grid_candidates(queries[s:s + rows], refs_sorted, starts,
                                       lo, inv_h, dims, cap)
        d2_k, pos = select_smallest(d2, k)
        out_i.append(slot.gather(1, pos))
        out_d.append(d2_k)
    return torch.cat(out_i), torch.cat(out_d)


def nearest_neighbor_indices_grid(
    queries,
    refs,
    cell_size: Optional[float] = None,
    cap: int = 48,
    q_block: int = 8192,
    _depth: int = 0,
    *,
    device=None,
) -> np.ndarray:
    """Grid-hashed 1-NN, exact by construction.

    Hashed answers are kept only when found within h/2 (every point that
    close lies inside the 2x2x2 window) with no bucket overflow; the rest
    retry through the grid at doubled cell size (and doubled ``cap``, at
    most 256) up to twice while more than 65,536 remain, then the exact
    1-NN takes the remainder.  ``queries`` (tensor or array) are searched
    on ``device`` (None: the card); the grid is built from the host copy of
    ``refs``.  Returns (N,) int32 indices into ``refs``.
    """
    device = device_or_card(device)
    q = torch.as_tensor(queries, dtype=torch.float32).to(device)
    refs = np.asarray(refs.cpu() if isinstance(refs, torch.Tensor) else refs,
                      dtype=np.float32)
    n, m = q.shape[0], len(refs)
    if n == 0:
        return np.zeros((0,), np.int32)
    if cell_size is None:
        cell_size = _choose_cell_size(refs, cap)
    order, grid = _grid_tensors(refs, cell_size, device)
    slot, d2, ovf = _grid_nn_core(q, *grid, int(cap), int(q_block))
    r2 = torch.tensor(np.float32((0.5 * cell_size) ** 2), device=device)
    enc = torch.where((d2 <= r2) & ~ovf, slot, torch.full_like(slot, -1)).cpu().numpy()
    resolved = enc >= 0
    result = order[np.clip(enc, 0, m - 1)].astype(np.int32)
    if not resolved.all():
        un = np.flatnonzero(~resolved)
        q_un = q[torch.from_numpy(un).to(device)]
        if _depth < 2 and len(un) > 65536:
            result[un] = nearest_neighbor_indices_grid(
                q_un, refs, cell_size=2.0 * cell_size, cap=min(2 * cap, 256),
                q_block=q_block, _depth=_depth + 1, device=device)
        else:
            result[un] = nearest_neighbor_indices(q_un, refs, device=device)
    return result


def knn_grid(
    queries,
    refs,
    k: int,
    cell_size: Optional[float] = None,
    cap: int = 48,
    q_block: int = 4096,
    device_arrays: bool = False,
    *,
    device=None,
):
    """Grid-hashed approximate k-NN for dense self-joins (outlier removal,
    normal estimation).  Candidates come from the 2x2x2 nearest cells (at
    most 8*cap); the cell size adapts so that p99 bucket occupancy stays
    within max(cap, k).  A query with fewer than k finite candidates keeps
    +inf distances; buckets beyond ``cap`` are truncated (use ``ops.knn``
    for the exact join).  The search runs on ``device`` (None: the card).

    Returns (indices (N, k) int32, dists (N, k) float32 Euclidean) as numpy,
    or with ``device_arrays`` the device tensors (indices (N, k) int64,
    SQUARED distances (N, k)), as the JAX package hands its callers device
    arrays of d2.  k is capped at 8 * cap.
    """
    device = device_or_card(device)
    q = torch.as_tensor(queries, dtype=torch.float32).to(device)
    refs = np.asarray(refs.cpu() if isinstance(refs, torch.Tensor) else refs,
                      dtype=np.float32)
    n, m = q.shape[0], len(refs)
    if n == 0:
        return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
    if cell_size is None:
        # Need ~4k candidates across the 8-cell neighbourhood.
        cell_size = _choose_cell_size(refs, max(cap, k))
    order, grid = _grid_tensors(refs, cell_size, device)
    slot, d2 = _grid_knn_core(q, *grid, int(cap), int(min(k, 8 * cap)), int(q_block))
    if device_arrays:
        order_dev = torch.from_numpy(order).to(device)
        return order_dev[slot.clamp(0, m - 1)], d2
    slot, d2 = slot.cpu().numpy(), d2.cpu().numpy()
    idx = order[np.clip(slot, 0, m - 1)].astype(np.int32)
    return idx, np.sqrt(np.maximum(np.where(np.isfinite(d2), d2, np.inf), 0.0)).astype(
        np.float32)
