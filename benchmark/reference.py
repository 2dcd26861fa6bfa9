"""The plain reference that decides ``correct``: numpy, scipy's exact
k-d tree and plain torch, in float64, importing nothing of the program.

It reads the program's outputs only to judge them (``read_ply``), and
works out again from the benchmark's own inputs (``benchmark/rooms.py``)
what the program derived: the trajectory (``benchmark/planner.py``), the
LiDAR's ray pattern, first hits along a ray, nearest TLS labels, PCA
normals, statistical outliers and boxes.

Each function takes a ``dtype``/``precision`` where the control
(``benchmark/control.py``) needs the same computation one precision below
the configuration's float32: bfloat16.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np
import torch

_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1", "short": "i2",
    "int16": "i2", "ushort": "u2", "uint16": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4", "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path) -> Dict[str, np.ndarray]:
    """A binary little-endian PLY as {element: structured array}.  A list
    property must hold the same count in every row (triangles: 3)."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    lines = data[:end].decode("ascii").splitlines()
    if lines[0] != "ply" or "binary_little_endian" not in lines[1]:
        raise ValueError(f"{path}: not a binary little-endian PLY")
    elements = []
    for line in lines[2:]:
        w = line.split()
        if w[0] == "element":
            elements.append([w[1], int(w[2]), []])
        elif w[0] == "property":
            elements[-1][2].append(w[1:])
    out, pos = {}, end
    for name, count, props in elements:
        fields = []
        for p in props:
            if p[0] == "list":
                n = int(np.frombuffer(data, "<" + _PLY_TYPES[p[1]], 1, pos)[0]) if count else 0
                fields += [(p[3] + "_n", "<" + _PLY_TYPES[p[1]]),
                           (p[3], "<" + _PLY_TYPES[p[2]], (n,))]
            else:
                fields.append((p[1], "<" + _PLY_TYPES[p[0]]))
        dt = np.dtype(fields)
        arr = np.frombuffer(data, dt, count, pos)
        for p in props:
            if p[0] == "list" and count and np.any(arr[p[3] + "_n"] != arr[p[3] + "_n"][0]):
                raise ValueError(f"{path}: ragged {p[3]}")
        out[name] = arr
        pos += dt.itemsize * count
    return out


def read_labeled_cloud(path):
    """(points (n, 3) float64, semantic ids, instance ids) of a labeled PLY."""
    v = read_ply(path)["vertex"]
    pts = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    return pts, v["sem"].astype(np.int64), v["ins"].astype(np.int64)


def read_mesh(path):
    """(vertices (V, 3) float64, triangles (T, 3) int64) of a mesh PLY."""
    e = read_ply(path)
    v = e["vertex"]
    verts = np.stack([v["x"], v["y"], v["z"]], 1).astype(np.float64)
    face = e["face"]
    key = [n for n in face.dtype.names if not n.endswith("_n")][0]
    return verts, face[key].astype(np.int64).reshape(len(face), -1)


def first_hit(origins, dirs, tris, device, dtype=torch.float64, rays_per_chunk=None):
    """Distance to the nearest triangle along each ray, +inf for a miss:
    Moller-Trumbore on both faces, closed (an edge counts as inside), every
    ray against every triangle.  origins, dirs (n, 3); tris (T, 3, 3)."""
    tri = torch.as_tensor(np.asarray(tris), dtype=dtype, device=device)
    v0 = tri[:, 0]
    e1 = tri[:, 1] - v0
    e2 = tri[:, 2] - v0
    o_all = torch.as_tensor(np.asarray(origins), dtype=dtype, device=device)
    d_all = torch.as_tensor(np.asarray(dirs), dtype=dtype, device=device)
    n = len(o_all)
    chunk = rays_per_chunk or max(1, (1 << 24) // max(len(tri), 1))
    out = torch.empty(n, dtype=torch.float64, device=device)
    for s in range(0, n, chunk):
        o = o_all[s:s + chunk, None, :]
        d = d_all[s:s + chunk, None, :]
        p = torch.cross(d.expand(-1, len(tri), 3), e2[None].expand(len(o), -1, 3), dim=2)
        det = (e1[None] * p).sum(2)
        sv = o - v0[None]
        u = (sv * p).sum(2) / det
        q = torch.cross(sv, e1[None].expand(len(o), -1, 3), dim=2)
        v = (d * q).sum(2) / det
        t = (e2[None] * q).sum(2) / det
        ok = (det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 0)
        t = torch.where(ok, t, torch.full_like(t, float("inf")))
        out[s:s + chunk] = t.min(1).values.double()
    return out.cpu().numpy()


def hit_gaps(points, origins, tris, device, dtype=torch.float64):
    """|first hit along origin -> point - |point - origin||, metres: 0 for a
    point that is the first surface its ray meets."""
    rel = np.asarray(points, np.float64) - np.asarray(origins, np.float64)
    length = np.linalg.norm(rel, axis=1)
    dirs = rel / np.maximum(length, 1e-300)[:, None]
    t = first_hit(origins, dirs, tris, device, dtype)
    return np.abs(t - length)


def cast_points(origins, dirs, tris, device, dtype):
    """The points a raycast in ``dtype`` gives: origin + dir * t, each
    product and sum in ``dtype`` (the control's stand-in for the scan)."""
    t = torch.as_tensor(first_hit(origins, dirs, tris, device, dtype), device=device)
    o = torch.as_tensor(np.asarray(origins), dtype=dtype, device=device)
    d = torch.as_tensor(np.asarray(dirs), dtype=dtype, device=device)
    return (o + d * t.to(dtype)[:, None]).double().cpu().numpy()


def sensor_pattern(pattern: Dict) -> np.ndarray:
    """(N, 3) float64 unit directions, in the sensor's frame, of the rays a
    LiDAR profile casts before its angle noise: a frozen copy of the port's
    ``models/beams.py`` closed forms.  ``pattern["kind"]``:

    - ``dual_axis`` (the BLK2GO spiral): ``rays`` over ``num_lines`` lines,
      line ``l`` at the elevation ``linspace(theta_max, theta_min)[l]`` plus
      ``swing_amplitude sin(swing_frequency phi + l pi / num_lines)``,
      clipped to the range, ``phi`` in equal steps round the circle;
    - ``grid``: every ``vertical_degrees`` elevation at ``horizontal_res``
      azimuths ``-(i - w/2) / w 2 pi``.
    """
    if pattern["kind"] == "dual_axis":
        lines = int(pattern["num_lines"])
        ppl = int(pattern["rays"]) // lines
        t_min, t_max = np.radians(pattern["theta_min_deg"]), np.radians(pattern["theta_max_deg"])
        line = np.repeat(np.arange(lines), ppl)
        phi = np.tile(np.arange(ppl) * (2.0 * np.pi / ppl), lines)
        swing = np.radians(pattern["swing_amplitude_deg"]) * np.sin(
            pattern["swing_frequency"] * phi + line * np.pi / lines)
        theta = np.clip(np.linspace(t_max, t_min, lines)[line] + swing, t_min, t_max)
    elif pattern["kind"] == "grid":
        w = int(pattern["horizontal_res"])
        elev = np.radians(np.asarray(pattern["vertical_degrees"], np.float64))
        theta = np.repeat(elev, w)
        phi = np.tile(-(np.arange(w) - w / 2.0) / w * 2.0 * np.pi, len(elev))
    else:
        raise ValueError(f"unknown ray pattern {pattern['kind']!r}")
    return np.stack([np.cos(theta) * np.cos(phi), np.cos(theta) * np.sin(phi),
                     np.sin(theta)], 1)


class RayPattern:
    """The nearest ray of a profile's pattern to a direction."""

    def __init__(self, pattern: Dict):
        from scipy.spatial import cKDTree

        self.tree = cKDTree(sensor_pattern(pattern))

    def gaps(self, points, poses_of_rows) -> np.ndarray:
        """Radians between each point's direction from its pose's origin,
        in that pose's frame, and the nearest ray of the pattern."""
        pose = np.asarray(poses_of_rows, np.float64)
        rel = np.asarray(points, np.float64) - pose[:, :3, 3]
        local = np.einsum("nji,nj->ni", pose[:, :3, :3], rel)  # R^T (p - o)
        local /= np.maximum(np.linalg.norm(local, axis=1, keepdims=True), 1e-300)
        chord, _ = self.tree.query(local, k=1, workers=-1)
        return 2.0 * np.arcsin(np.minimum(chord / 2.0, 1.0))


def twin_share(points, device) -> float:
    """The share of rows whose coordinates, bit for bit, another row has."""
    p = torch.as_tensor(np.ascontiguousarray(np.asarray(points, np.float32)), device=device)
    if len(p) == 0:
        return 0.0
    _, inverse, counts = torch.unique(p.view(torch.int32), dim=0, return_inverse=True,
                                      return_counts=True)
    return float((counts[inverse] > 1).sum().item()) / len(p)


def round_to(x: np.ndarray, dtype) -> np.ndarray:
    """``x`` rounded to ``dtype`` and back to float64."""
    return torch.as_tensor(np.asarray(x, np.float64)).to(dtype).double().numpy()


class LabelReference:
    """The exact nearest TLS points of a room (a k-d tree in float64)."""

    def __init__(self, ref_points, ref_sem, ref_ins):
        from scipy.spatial import cKDTree

        self.points = np.asarray(ref_points, np.float64)
        self.key = np.asarray(ref_sem, np.int64) * 100_000 + np.asarray(ref_ins, np.int64)
        self.tree = cKDTree(self.points)

    def wrong(self, queries, sem, ins, tol: float, k: int = 8) -> np.ndarray:
        """True where the label (sem, ins) given to a query is the label of
        none of its nearest TLS points: none of the TLS points within
        ``tol`` metres of the nearest distance carries it."""
        dist, idx = self.tree.query(np.asarray(queries, np.float64), k=k, workers=-1)
        key = np.asarray(sem, np.int64) * 100_000 + np.asarray(ins, np.int64)
        near = dist <= dist[:, :1] + tol
        return ~np.any(near & (self.key[idx] == key[:, None]), axis=1)

    def labels(self, queries, dtype=None):
        """(sem, ins) of the nearest TLS point; with ``dtype`` both clouds
        are first rounded to it (the control)."""
        from scipy.spatial import cKDTree

        if dtype is None:
            _, idx = self.tree.query(np.asarray(queries, np.float64), k=1)
        else:
            tree = cKDTree(round_to(self.points, dtype))
            _, idx = tree.query(round_to(queries, dtype), k=1)
        key = self.key[idx]
        return key // 100_000, key % 100_000


def stat_outlier_mask(points, k: int, std_ratio: float, dtype=None) -> np.ndarray:
    """Inliers by the statistical rule: a point's mean distance to its k
    nearest other points at most mean + std_ratio * std over all points
    (population std)."""
    from scipy.spatial import cKDTree

    p = np.asarray(points, np.float64) if dtype is None else round_to(points, dtype)
    dist, _ = cKDTree(p).query(p, k=k + 1, workers=-1)
    mean = dist[:, 1:].mean(1)
    return mean <= mean.mean() + std_ratio * mean.std()


def pca_normals(points, queries, radius: float, max_nn: int, exclude=None,
                dtype=None) -> np.ndarray:
    """Unit normals at ``queries``: the eigenvector of the smallest
    eigenvalue of the covariance of the (at most ``max_nn``) nearest points
    of ``points`` within ``radius``, leaving out ``exclude`` (a mask over
    ``points``).  Sign is arbitrary."""
    from scipy.spatial import cKDTree

    p = np.asarray(points, np.float64) if dtype is None else round_to(points, dtype)
    q = np.asarray(queries, np.float64) if dtype is None else round_to(queries, dtype)
    dist, idx = cKDTree(p).query(q, k=max_nn, workers=-1)
    valid = dist <= radius
    if exclude is not None:
        valid &= ~np.asarray(exclude)[idx]
    nb = p[idx]
    w = valid[..., None].astype(np.float64)
    cnt = np.maximum(w.sum(1), 1.0)
    mean = (nb * w).sum(1) / cnt
    c = (nb - mean[:, None]) * w
    cov = np.einsum("nki,nkj->nij", c, c) / cnt[:, None]
    _, vec = np.linalg.eigh(cov)
    return vec[:, :, 0]


def aabb(points):
    p = np.asarray(points, np.float64)
    return p.min(0), p.max(0)
