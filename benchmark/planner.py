"""The reference's trajectory: a frozen copy of the upstream project's auto
planner (``trajectory/auto_trajectory_generator.py``, as the port keeps it
in ``ipcgen_tpu_torch/trajectory/auto.py``), in the mode that the sim
stage runs: free cells by the mesh's vertices, seeded 0, robot radius
0.15, at the robot height 1.0.

Plan: classify a grid of cells at robot height as free (no mesh vertex
inside the robot's cube), connect free cells within two radii, draw up to
40 start and end pairs, find each pair's A* path through the free cells,
resample it by arc length to ``max(2 num_waypoints, 40)`` waypoints and
smooth it, count each candidate's waypoints that leave the room or hold a
vertex, and keep the best by length, smoothness and collisions.  Every
formula is the upstream one; only the data structures are plain, so the
same mesh gives the same waypoints, bit for bit, whatever implements them.
"""

from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np

ROBOT_RADIUS = 0.15
ROBOT_HEIGHT = 1.0
MAX_CANDIDATES = 40
INTERPOLATION_DENSITY = 2.0
MIN_WAYPOINTS = 40


def _free_cells(verts: np.ndarray, lo: np.ndarray, hi: np.ndarray, res: float) -> np.ndarray:
    """(n, 3) centres of the free cells, x-major: cells whose robot cube
    lies inside the room and holds no vertex."""
    r, z = ROBOT_RADIUS, ROBOT_HEIGHT
    xs = np.arange(lo[0], hi[0], res)
    ys = np.arange(lo[1], hi[1], res)
    if len(xs) == 0 or len(ys) == 0 or not (z - r >= lo[2] and z + r <= hi[2]):
        return np.zeros((0, 3))
    occupied = np.zeros((len(xs), len(ys)), bool)
    band = verts[(verts[:, 2] >= z - r) & (verts[:, 2] <= z + r)]
    # A vertex occupies every cell whose centre lies within r of it on
    # both axes.
    ilo = np.searchsorted(xs, band[:, 0] - r, "left")
    ihi = np.searchsorted(xs, band[:, 0] + r, "right")
    jlo = np.searchsorted(ys, band[:, 1] - r, "left")
    jhi = np.searchsorted(ys, band[:, 1] + r, "right")
    for di in range(int(max((ihi - ilo).max(initial=0), 0))):
        for dj in range(int(max((jhi - jlo).max(initial=0), 0))):
            m = (ilo + di < ihi) & (jlo + dj < jhi)
            occupied[ilo[m] + di, jlo[m] + dj] = True
    in_x = (xs - r >= lo[0]) & (xs + r <= hi[0])
    in_y = (ys - r >= lo[1]) & (ys + r <= hi[1])
    i, j = np.nonzero(in_x[:, None] & in_y[None, :] & ~occupied)
    return np.stack([xs[i], ys[j], np.full(len(i), z)], 1)


def _a_star(adj: List[np.ndarray], pts: np.ndarray, start: int, end: int) -> Optional[List[int]]:
    if start == end:
        return [start]

    def h(i, j):
        return float(np.linalg.norm(pts[i] - pts[j]))

    g = {start: 0.0}
    came = {}
    heap = [(h(start, end), start)]
    closed = set()
    while heap:
        _, cur = heapq.heappop(heap)
        if cur == end:
            path = [cur]
            while cur in came:
                cur = came[cur]
                path.append(cur)
            return path[::-1]
        if cur in closed:
            continue
        closed.add(cur)
        for nb in adj[cur]:
            nb = int(nb)
            if nb in closed:
                continue
            tentative = g[cur] + h(cur, nb)
            if tentative < g.get(nb, float("inf")):
                came[nb] = cur
                g[nb] = tentative
                heapq.heappush(heap, (tentative + h(nb, end), nb))
    return None


def _linear(a: np.ndarray, b: np.ndarray, n: int) -> np.ndarray:
    return np.stack([a + (i / (n - 1) if n > 1 else 0) * (b - a) for i in range(n)])


def _along(path: np.ndarray, n: int) -> np.ndarray:
    """``n`` points at equal arc length along ``path``."""
    seg = np.linalg.norm(np.diff(path, axis=0), axis=1)
    total = float(seg.sum())
    if total < 1e-6:
        return path[:1]
    cum = np.concatenate([[0.0], np.cumsum(seg)])
    out = []
    for i in range(n):
        if i == n - 1:
            out.append(path[-1])
            continue
        target = (i / (n - 1)) * total
        k = int(np.clip(np.searchsorted(cum, target, "right") - 1, 0, len(seg) - 1))
        progress = (target - cum[k]) / seg[k] if seg[k] > 0 else 0
        out.append(path[k] + progress * (path[k + 1] - path[k]))
    return np.stack(out)


def _smooth(p: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    if len(p) < 3:
        return p
    out = p.copy()
    out[1:-1] = alpha * p[1:-1] + (1 - alpha) * (p[:-2] + p[2:]) / 2
    return out


def _collisions(p: np.ndarray, verts: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> int:
    """Waypoints whose robot cube leaves the room or holds a vertex."""
    r = ROBOT_RADIUS
    outside = ~np.all((lo <= p - r) & (p + r <= hi), axis=1)
    band = verts[(verts[:, 2] >= p[:, 2].min() - r) & (verts[:, 2] <= p[:, 2].max() + r)]
    band = band[np.argsort(band[:, 0], kind="stable")]
    lo_i = np.searchsorted(band[:, 0], p[:, 0] - r, "left")
    hi_i = np.searchsorted(band[:, 0], p[:, 0] + r, "right")
    holds = np.array([np.any(np.all((band[a:b] >= q - r) & (band[a:b] <= q + r), axis=1))
                      for q, a, b in zip(p, lo_i, hi_i)])
    return int(np.sum(outside | holds))


def plan(verts: np.ndarray, num_waypoints: int, seed: int = 0) -> np.ndarray:
    """(W, 4) waypoints ``x y z yaw`` of the planner over a mesh's
    vertices (float64); the room is the vertices' box."""
    verts = np.asarray(verts, np.float64)
    lo, hi = verts.min(0), verts.max(0)
    dims = hi - lo
    rng = np.random.default_rng(seed)
    min_length = max(dims[0], dims[1]) * 0.2
    free = _free_cells(verts, lo, hi, max(0.2, float(min(dims)) / 20))
    if len(free) < 10:
        free = _free_cells(verts, lo, hi, max(0.15, float(min(dims)) / 30))
    n = len(free)
    d2 = np.sum((free[:, None, :] - free[None, :, :]) ** 2, axis=2)
    adj = [np.nonzero(row)[0] for row in (d2 <= (2 * ROBOT_RADIUS) ** 2) & ~np.eye(n, dtype=bool)]
    dense = max(int(num_waypoints * INTERPOLATION_DENSITY), MIN_WAYPOINTS)
    best, best_score = None, -np.inf
    for _ in range(min(MAX_CANDIDATES, n * 2) if n >= 2 else 0):
        s_idx = int(rng.integers(0, n))
        e_idx = int(rng.integers(0, n))
        if s_idx == e_idx:
            continue
        start, end = free[s_idx], free[e_idx]
        if np.linalg.norm(start - end) < min_length:
            continue
        # The drawn points are free cells themselves: their nearest free
        # cells are they.
        path = _a_star(adj, free, s_idx, e_idx)
        if path is None or len(path) < 2:
            p = _linear(start, end, dense)
        else:
            pts = [free[i] for i in path]
            if len(pts) == 2:
                p = _linear(pts[0], pts[1], dense)
            else:
                p = _smooth(_along(np.stack(pts), dense))
        length = float(np.linalg.norm(np.diff(p, axis=0), axis=1).sum()) if len(p) > 1 else 0.0
        # Every waypoint's yaw is 0, so the smoothness score is 1.
        score = min(length / min_length, 2.0) * 0.4 + 1.0 * 0.4 \
            - _collisions(p, verts, lo, hi) * 0.1
        if score > best_score:
            best, best_score = p, score
    if best is None:
        raise ValueError("no trajectory candidate")
    return np.concatenate([best, np.zeros((len(best), 1))], axis=1)


def poses(waypoints: np.ndarray) -> np.ndarray:
    """(W, 4, 4) float32 poses: the yaw about z and the position."""
    w = np.asarray(waypoints, np.float64)
    out = np.zeros((len(w), 4, 4))
    c, s = np.cos(w[:, 3]), np.sin(w[:, 3])
    out[:, 0, 0], out[:, 0, 1], out[:, 1, 0], out[:, 1, 1] = c, -s, s, c
    out[:, 2, 2] = out[:, 3, 3] = 1.0
    out[:, :3, 3] = w[:, :3]
    return out.astype(np.float32)
