"""Closed ray-triangle references in float64 and in rational arithmetic.

The pair walk's edge test (``ops/raycast_pairs.py``, "The edge test") is
held to these: they take the same float32 inputs (the ray's o and d, and
``tri_data`` rows 0-8: v0, e1, e2) and decide in wider arithmetic, with
closed triangles (a barycentric or edge side of 0 is inside).  Nothing here
shares code with the walk.

- ``closed_mt64``: Moller-Trumbore in float64 (numpy), one triangle a ray;
  it also flags the rays whose decision lies within ``EXACT_MARGIN`` of a
  barycentric boundary, where float64 is not watertight;
- ``closed_exact``: the same decision in rational arithmetic, for one ray,
  from the Pluecker edge sides ``exact_side``;
- ``nearest_mt64``: the nearest ``closed_mt64`` hit over a set of triangles.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

EPS_T = 1e-6  # a hit needs t > EPS_T
EXACT_MARGIN = 1e-9  # float64 decisions this near their boundary go to exact arithmetic


def asset_rows(tri_data, tri_index) -> tuple[np.ndarray, np.ndarray]:
    """(slots, 9) float64 v0, e1, e2 of every packed slot of a scene asset's
    ``tri_data`` (NB, 16, TB), and (slots,) the original triangle id of each
    (-1: padding)."""
    rows = tri_data[:, 0:9].permute(0, 2, 1).reshape(-1, 9).cpu().double().numpy()
    return rows, tri_index.cpu().numpy()


def closed_mt64(o, d, rows, t_max: float = np.inf):
    """Float64 Moller-Trumbore, closed (u, v >= 0, u + v <= 1), of rays o, d
    (n, 3) against triangles ``rows`` (n, 9) v0, e1, e2 (or one (9,) row for
    every ray): (hit with EPS_T < t < t_max, t (+inf on a miss), near: a
    barycentric within EXACT_MARGIN of its boundary)."""
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    rows = np.asarray(rows, np.float64)
    v0, e1, e2 = rows[..., 0:3], rows[..., 3:6], rows[..., 6:9]
    p = np.cross(d, e2)
    det = np.einsum("ij,ij->i", np.broadcast_to(e1, p.shape), p)
    tv = o - v0
    q = np.cross(tv, e1)
    with np.errstate(divide="ignore", invalid="ignore"):
        u = np.einsum("ij,ij->i", tv, p) / det
        v = np.einsum("ij,ij->i", d, q) / det
        t = np.einsum("ij,ij->i", np.broadcast_to(e2, q.shape), q) / det
    hit = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > EPS_T) & (t < t_max)
    near = (det != 0) & (np.minimum(np.minimum(np.abs(u), np.abs(v)), np.abs(1 - u - v))
                         < EXACT_MARGIN)
    return hit, np.where(hit, t, np.inf), near


def _cross(x, y):
    return (x[1] * y[2] - x[2] * y[1], x[2] * y[0] - x[0] * y[2], x[0] * y[1] - x[1] * y[0])


def _dot(x, y):
    return x[0] * y[0] + x[1] * y[1] + x[2] * y[2]


def _fractions(v):
    return [Fraction(float(x)) for x in v]


def exact_side(o, d, p, q) -> Fraction:
    """The Pluecker side d.(p x q) + (o x d).(q - p) of the edge p -> q, in
    rational arithmetic on the given (float) coordinates."""
    o, d, p, q = (_fractions(v) for v in (o, d, p, q))
    return _dot(d, _cross(p, q)) + _dot(_cross(o, d), [q[i] - p[i] for i in range(3)])


def closed_exact(o, d, row, t_max: float = np.inf):
    """``closed_mt64`` for one ray and one triangle in rational arithmetic:
    (hit, t as a Fraction or None).  Inside: each edge side (``exact_side``)
    of a = v0, b = v0 + e1, c = v0 + e2 is 0 or of the sign of
    den = d.(e1 x e2)."""
    o, d, row = (_fractions(v) for v in (o, d, row))
    v0, e1, e2 = row[0:3], row[3:6], row[6:9]
    a = v0
    b = [v0[i] + e1[i] for i in range(3)]
    c = [v0[i] + e2[i] for i in range(3)]
    n = _cross(e1, e2)
    den = _dot(d, n)
    if den == 0:
        return False, None
    for pp, qq in ((a, b), (b, c), (c, a)):
        side = exact_side(o, d, pp, qq)
        if side != 0 and (side > 0) != (den > 0):
            return False, None
    t = _dot([v0[i] - o[i] for i in range(3)], n) / den
    hit = Fraction(EPS_T) < t and (not np.isfinite(t_max) or t < Fraction(float(t_max)))
    return hit, t if hit else None


def nearest_mt64(o, d, rows, ids, t_max: float = np.inf):
    """The nearest ``closed_mt64`` hit of rays o, d (n, 3) over triangles
    ``rows`` (m, 9) with original ids ``ids`` (m,); rows of id -1 are
    skipped.  Returns (hit (n,) bool, tri_id (n,), -1 on a miss); a tie in
    t goes to the first row."""
    best = np.full(len(o), np.inf)
    best_id = np.full(len(o), -1)
    for row, tid in zip(rows, ids):
        if tid < 0:
            continue
        hit, t, _ = closed_mt64(o, d, row, t_max)
        take = hit & (t < best)
        best = np.where(take, t, best)
        best_id = np.where(take, tid, best_id)
    return np.isfinite(best), best_id
