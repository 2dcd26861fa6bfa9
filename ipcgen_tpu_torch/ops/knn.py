"""Exact nearest-neighbour searches (port of ``ipcgen_tpu/ops/knn.py``).

- ``nearest_neighbor_indices`` (:140-180): exact 1-NN, the label grid's
  residue path and the annotation colour fallback; on the card the
  hand-written kernel ``csrc/nn_exact.cu`` (``nearest_neighbor_tensor``),
  on the CPU its plain version, the chunked loop
  (``nearest_neighbor_plain``);
- ``knn`` (:225-260): exact k-NN, the self-join of the outlier means and
  the PCA normals below the grid path's size;
- ``exact_pair_budget`` and ``nearest_neighbor_auto`` (:109-137): the
  exact join below a pair budget, the grid-hashed 1-NN above it.

Distances are direct squared differences, not the norm expansion |q|^2 -
2 q.r + |r|^2 of the JAX package, whose float32 cancellation makes
sub-millimetre near-ties resolve either way; nothing here goes through a
matmul.  Ties go to the smallest reference index, as ``argmin`` and
``jax.lax.top_k`` resolve them.  The JAX package selects approximately
(``approx_min_k``) above 65,536 references on the TPU; off the TPU that
selection is exact, and here every selection is exact.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ipcgen_tpu_torch.utils.device import device_or_card

# (query, reference) pairs per chunk of the exact k-NN: a few (rows, M)
# float32 and int64 buffers of this many elements live at once.
_KNN_PAIRS = {"cuda": 1 << 24, "cpu": 1 << 22}


def select_smallest(d2: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` smallest entries of each row of ``d2`` (non-negative or
    +inf), ascending, ties to the smaller position: (values (B, k), positions
    (B, k) int64).

    ``torch.topk`` promises no order among equal values, so the selection
    runs on one int64 key per entry, the float's bits above the position:
    for non-negative floats the bits order as the values do.
    """
    pos = torch.arange(d2.shape[1], device=d2.device, dtype=torch.int64)
    key = (d2.contiguous().view(torch.int32).to(torch.int64) << 32) | pos
    key = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    vals = (key >> 32).to(torch.int32).view(torch.float32)
    return vals, key & 0xFFFFFFFF


def nearest_neighbor_plain(q: torch.Tensor, r: torch.Tensor, q_block: int = 1024,
                           max_elems: int = 1 << 24) -> torch.Tensor:
    """The plain version of the exact 1-NN kernel: (N,) int64 indices into
    ``r`` (M, 3) of the nearest reference to each row of ``q`` (N, 3), both
    float32 on one device, N > 0 and M > 0.  Blocks of ``q_block`` queries
    against chunks of references, (B, chunk) squared distances (dx^2 +
    dy^2) + dz^2 at most ``max_elems // 3`` at a time; ties to the smallest
    index."""
    n, m = q.shape[0], r.shape[0]
    r_block = max(1, max_elems // (3 * q_block))
    out = torch.empty(n, dtype=torch.int64, device=q.device)
    for s in range(0, n, q_block):
        qb = q[s:s + q_block]
        best_d = torch.full((qb.shape[0],), float("inf"), device=q.device)
        best_i = torch.zeros(qb.shape[0], dtype=torch.int64, device=q.device)
        for c in range(0, m, r_block):
            rc = r[c:c + r_block]
            d2 = (qb[:, 0:1] - rc[None, :, 0]) ** 2
            d2 = d2 + (qb[:, 1:2] - rc[None, :, 1]) ** 2
            d2 = d2 + (qb[:, 2:3] - rc[None, :, 2]) ** 2
            dmin, arg = torch.min(d2, dim=1)
            take = dmin < best_d
            best_d = torch.where(take, dmin, best_d)
            best_i = torch.where(take, arg + c, best_i)
        out[s:s + q_block] = best_i
    return out


def nearest_neighbor_tensor(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Exact 1-NN on the tensors' device: (N,) int64 indices, on that
    device, into ``r`` (M, 3) of the nearest reference to each row of ``q``
    (N, 3), ties to the smallest index.  CPU tensors take the plain version;
    CUDA tensors the kernel (``_kernels.nn_exact_cuda``), which raises for
    what it does not take.  An empty reference set raises."""
    q = q.to(torch.float32).contiguous()
    r = r.to(torch.float32).contiguous()
    if q.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.int64, device=q.device)
    if r.shape[0] == 0:
        raise ValueError("nearest_neighbor_indices: empty reference set.")
    if q.device.type == "cpu":
        return nearest_neighbor_plain(q, r)
    from ipcgen_tpu_torch.ops import _kernels

    if r.data_ptr() % 16:  # a row slice: the kernel's cp.async copies need 16 bytes
        r = r.clone()
    return _kernels.nn_exact_cuda(q, r)


def nearest_neighbor_indices(queries, refs, device=None, q_block: int = 1024,
                             max_elems: int = 1 << 24) -> np.ndarray:
    """Index of the nearest reference point for every query point.

    ``queries`` (N, 3) and ``refs`` (M, 3) are tensors or arrays; the search
    runs on ``device`` (default: the queries' device, CPU for arrays) through
    ``nearest_neighbor_tensor``; on the CPU ``q_block`` and ``max_elems``
    size the plain version's chunks.  Returns (N,) int32 numpy indices into
    ``refs``.
    """
    if device is None:
        device = queries.device if isinstance(queries, torch.Tensor) else "cpu"
    q = torch.as_tensor(queries, dtype=torch.float32).to(device)
    r = torch.as_tensor(refs, dtype=torch.float32).to(device)
    if q.device.type == "cpu" and q.shape[0] and r.shape[0]:
        idx = nearest_neighbor_plain(q, r, q_block, max_elems)
    else:
        idx = nearest_neighbor_tensor(q, r)
    return idx.cpu().numpy().astype(np.int32)


def exact_pair_budget(*, device=None) -> float:
    """Pair count above which callers should prefer the grid-hashed 1-NN
    (``ops.grid_nn``) over the exact join: 1e10 when the queries live on the
    card (``device`` None: the card), 2e8 on the CPU."""
    return 1e10 if torch.device("cuda" if device is None else device).type == "cuda" else 2e8


def nearest_neighbor_auto(queries, refs, cap: int = 24, *, device=None) -> np.ndarray:
    """Budget-gated 1-NN on ``device`` (None: the card): the grid-hashed
    join above ``exact_pair_budget()`` pairs, the exact join otherwise.
    Both inputs of a surface-to-surface transfer sample the same surface,
    so the hashed cells resolve essentially every query; both paths return
    the true nearest neighbour.  (N,) int32 indices into ``refs``."""
    device = device_or_card(device)
    if len(queries) * len(refs) > exact_pair_budget(device=device):
        from ipcgen_tpu_torch.ops.grid_nn import nearest_neighbor_indices_grid

        return nearest_neighbor_indices_grid(queries, refs, cap=cap, device=device)
    return nearest_neighbor_indices(queries, refs, device=device)


def knn(
    queries, refs, k: int, q_block: int = 256, exact: Optional[bool] = None, *,
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """k nearest reference points for every query point, on ``device``
    (None: the card).

    Exact for every size: ``exact`` is accepted for the JAX package's
    signature and changes nothing.  ``q_block`` is the least number of query
    rows a chunk holds; chunks grow to a fixed pair budget.  k above the
    reference count repeats the last column, as in the JAX package.

    Returns
    -------
    indices : (N, k) int32, ascending by distance, ties to the smaller index.
    dists : (N, k) float32 Euclidean (not squared) distances.
    """
    device = device_or_card(device)
    q = torch.as_tensor(queries, dtype=torch.float32).to(device)
    r = torch.as_tensor(refs, dtype=torch.float32).to(device)
    n, m = q.shape[0], r.shape[0]
    if n == 0:
        return np.zeros((0, k), np.int32), np.zeros((0, k), np.float32)
    if m == 0:
        raise ValueError("knn: empty reference set.")
    k_eff = min(k, m)
    rows = max(q_block, _KNN_PAIRS.get(device.type, 1 << 22) // m, 1)
    out_i, out_d = [], []
    for s in range(0, n, rows):
        qb = q[s:s + rows]
        d2 = (qb[:, 0:1] - r[None, :, 0]) ** 2
        d2 = d2 + (qb[:, 1:2] - r[None, :, 1]) ** 2
        d2 = d2 + (qb[:, 2:3] - r[None, :, 2]) ** 2
        vals, pos = select_smallest(d2, k_eff)
        out_i.append(pos)
        out_d.append(vals)
    idx = torch.cat(out_i).to(torch.int32).cpu().numpy()
    d2 = torch.cat(out_d).cpu().numpy()
    if k_eff < k:  # pad out to the requested k by repeating the last column
        idx = np.concatenate([idx, np.repeat(idx[:, -1:], k - k_eff, axis=1)], axis=1)
        d2 = np.concatenate([d2, np.repeat(d2[:, -1:], k - k_eff, axis=1)], axis=1)
    return idx, np.sqrt(np.maximum(d2, 0.0)).astype(np.float32)
