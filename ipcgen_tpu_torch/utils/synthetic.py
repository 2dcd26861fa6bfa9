"""Synthetic scenes: a furnished room with a matching S3DIS-format TLS room,
and the small cluttered room the raycast kernels are checked on.

``synthetic_room`` is the mesh of ``scripts/bench_raycast.py:15-59`` (an
inward 6 x 5 x 2.5 m box with 12 furniture boxes, 1->4 subdivided towards a
target triangle count), copied here so that the port and ``chip_smoke.py``
need nothing outside the package.  ``write_s3dis_room`` samples points on the
same surfaces and writes them in the S3DIS layout the label path reads: the
room txt (``x y z r g b``) plus ``Annotations/{class}_{k}.txt``.

``cluttered_room``, ``hardware_rays`` and ``hardware_scene`` are the scene
and rays of ``tests/test_tpu_hardware.py:31-50``, shared by ``chip_smoke.py``
and the port's tests.

``patch_ordered_scan_rays`` is the ray set of
``scripts/bench_kernel_iter.py:21-36``, which the kernel probe
(``ipcgen_tpu_torch/kernel_probe.py``) casts.
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Tuple

import numpy as np

ROOM_CENTER = (3.0, 2.5, 1.25)
ROOM_SIZE = (6.0, 5.0, 2.5)
FURNITURE_CLASSES = ("table", "chair", "sofa", "bookcase")
CLASS_COLORS = {
    "ceiling": (200, 200, 200), "floor": (120, 100, 80), "wall": (180, 170, 150),
    "table": (150, 90, 40), "chair": (60, 60, 160), "sofa": (160, 40, 40),
    "bookcase": (90, 60, 20),
}


def furniture_boxes(seed: int = 0) -> List[Tuple[Tuple[float, ...], Tuple[float, ...]]]:
    """(center, size) of the 12 furniture boxes, in the mesh's draw order."""
    rng = np.random.default_rng(seed)
    boxes = []
    for _ in range(12):
        cx, cy = rng.uniform(0.5, 5.5), rng.uniform(0.5, 4.5)
        sx, sy, sz = rng.uniform(0.3, 1.2, 3)
        boxes.append(((cx, cy, sz / 2), (sx, sy, sz)))
    return boxes


def subdivide(verts, tris, levels=1):
    """1->4 midpoint subdivision (no smoothing)."""
    for _ in range(levels):
        c = verts[tris]
        m01 = (c[:, 0] + c[:, 1]) / 2
        m12 = (c[:, 1] + c[:, 2]) / 2
        m20 = (c[:, 2] + c[:, 0]) / 2
        verts = np.concatenate([c[:, 0], c[:, 1], c[:, 2], m01, m12, m20], axis=0)
        t = len(tris)
        i0, i1, i2 = np.arange(t), np.arange(t) + t, np.arange(t) + 2 * t
        a, b, cc = np.arange(t) + 3 * t, np.arange(t) + 4 * t, np.arange(t) + 5 * t
        tris = np.concatenate([
            np.stack([i0, a, cc], 1), np.stack([a, i1, b], 1),
            np.stack([cc, b, i2], 1), np.stack([a, b, cc], 1),
        ]).astype(np.int32)
    return verts, tris


def synthetic_room(target_tris: int, seed: int = 0):
    """(vertices float32, triangles int32) with the largest 4^k multiple of
    156 triangles not above ``target_tris``."""
    from ipcgen_tpu_torch.containers.mesh import TriMesh

    room = TriMesh.box(center=ROOM_CENTER, size=ROOM_SIZE, inward=True)
    verts, tris = [room.vertices], [room.triangles]
    off = len(room.vertices)
    for center, size in furniture_boxes(seed):
        b = TriMesh.box(center=center, size=size)
        verts.append(b.vertices)
        tris.append(b.triangles + off)
        off += len(b.vertices)
    v = np.concatenate(verts)
    t = np.concatenate(tris).astype(np.int32)
    while len(t) * 4 <= target_tris:
        v, t = subdivide(v, t)
    return v.astype(np.float32), t


def _rect(rng, n, origin, u, v):
    ab = rng.uniform(0.0, 1.0, (n, 2))
    return np.asarray(origin, float) + ab[:, :1] * np.asarray(u, float) \
        + ab[:, 1:] * np.asarray(v, float)


def _surfaces(seed: int):
    """[(instance name, [(origin, u, v), ...])] for the shell and furniture."""
    w, d, h = ROOM_SIZE
    out = [
        ("floor_1", [((0, 0, 0), (w, 0, 0), (0, d, 0))]),
        ("ceiling_1", [((0, 0, h), (w, 0, 0), (0, d, 0))]),
        ("wall_1", [((0, 0, 0), (w, 0, 0), (0, 0, h))]),
        ("wall_2", [((0, d, 0), (w, 0, 0), (0, 0, h))]),
        ("wall_3", [((0, 0, 0), (0, d, 0), (0, 0, h))]),
        ("wall_4", [((w, 0, 0), (0, d, 0), (0, 0, h))]),
    ]
    counts = {}
    for k, (center, size) in enumerate(furniture_boxes(seed)):
        cls = FURNITURE_CLASSES[k % len(FURNITURE_CLASSES)]
        counts[cls] = counts.get(cls, 0) + 1
        lo = np.asarray(center) - np.asarray(size) / 2
        faces = []
        for axis in range(3):
            for side in (0, 1):
                if axis == 2 and side == 0:
                    continue  # boxes stand on the floor
                a1, a2 = [a for a in range(3) if a != axis]
                u, v = np.zeros(3), np.zeros(3)
                u[a1], v[a2] = size[a1], size[a2]
                origin = lo.copy()
                origin[axis] += side * size[axis]
                faces.append((origin, u, v))
        out.append((f"{cls}_{counts[cls]}", faces))
    return out


def write_s3dis_room(room_dir, n_points: int = 600_000, seed: int = 0) -> int:
    """Write ``{room}.txt`` and ``Annotations/*.txt`` for the synthetic room
    under ``room_dir`` (its last path part is the room name), with about
    ``n_points`` points spread over the surfaces by area.  Returns the count."""
    room_dir = Path(room_dir)
    ann_dir = room_dir / "Annotations"
    ann_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed + 1)
    surfaces = _surfaces(seed)
    area = lambda u, v: float(np.linalg.norm(np.cross(u, v)))
    total = sum(area(u, v) for _, faces in surfaces for _, u, v in faces)
    rows = []
    for name, faces in surfaces:
        pts = np.vstack([
            _rect(rng, max(int(n_points * area(u, v) / total), 16), o, u, v)
            for o, u, v in faces
        ])
        base = np.asarray(CLASS_COLORS[name.rsplit("_", 1)[0]])
        rgb = np.clip(base + rng.integers(-12, 13, (len(pts), 3)), 0, 255)
        r = np.hstack([np.round(pts, 3), rgb])
        np.savetxt(ann_dir / f"{name}.txt", r, fmt="%.3f %.3f %.3f %d %d %d")
        rows.append(r)
    room = np.vstack(rows)
    room = room[rng.permutation(len(room))]
    np.savetxt(room_dir / f"{room_dir.name}.txt", room,
               fmt="%.3f %.3f %.3f %d %d %d")
    return len(room)


def cluttered_room(rng: np.random.Generator, n_boxes: int = 5):
    """An inward 4 x 3 x 2.5 m room with ``n_boxes`` random boxes drawn from
    ``rng`` (the scene of tests/test_raycast_mxu.py:22-34); (vertices
    float32, triangles int32)."""
    from ipcgen_tpu_torch.containers.mesh import TriMesh

    room = TriMesh.box(center=(2, 1.5, 1.25), size=(4, 3, 2.5), inward=True)
    vs, ts = [room.vertices], [room.triangles]
    off = len(room.vertices)
    for _ in range(n_boxes):
        c = rng.uniform([0.6, 0.6, 0.2], [3.4, 2.4, 1.0])
        b = TriMesh.box(center=tuple(c), size=tuple(rng.uniform(0.2, 0.8, 3)))
        vs.append(b.vertices)
        ts.append(b.triangles + off)
        off += len(b.vertices)
    return (np.concatenate(vs).astype(np.float32),
            np.concatenate(ts).astype(np.int32))


def hardware_rays(rng: np.random.Generator, n: int):
    """``n`` unit rays from the room centre, the last quarter from origins
    outside the room (tests/test_tpu_hardware.py:45-50); (origins, dirs)
    float32."""
    origins = np.tile(np.array([2, 1.5, 1.0], np.float32), (n, 1))
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins[3 * n // 4:] = rng.uniform(-12, -6, (n // 4, 3)).astype(np.float32)
    return origins, dirs


def hardware_scene(n: int):
    """The cluttered room (seed 0, six boxes) and ``n`` of its rays:
    (vertices, triangles, origins, dirs)."""
    rng = np.random.default_rng(0)
    verts, tris = cluttered_room(rng, n_boxes=6)
    return verts, tris, *hardware_rays(rng, n)


def patch_ordered_scan_rays(num_waypoints: int = 20, r: int = 128_000,
                            lines: int = 32):
    """A dense ``lines``-line scan of ``r`` rays (15 to -20 degrees) in patch
    order, cast from ``num_waypoints`` origins on the line y = 2.5, z = 1
    between x = 1 and x = 5: (origins, dirs) float32, waypoint-major."""
    from ipcgen_tpu_torch.sim.scan import patch_permutation

    phis = np.tile(np.linspace(0, 2 * np.pi, r // lines, endpoint=False), lines)
    thetas = np.repeat(np.deg2rad(np.linspace(15, -20, lines)), r // lines)
    dirs = np.stack(
        [np.cos(thetas) * np.cos(phis), np.cos(thetas) * np.sin(phis),
         np.sin(thetas)], axis=1).astype(np.float32)
    dirs = dirs[patch_permutation(lines, r // lines)]
    xs = np.linspace(1.0, 5.0, num_waypoints)
    origins = np.repeat(
        np.stack([xs, np.full(num_waypoints, 2.5), np.full(num_waypoints, 1.0)],
                 axis=1), r, axis=0).astype(np.float32)
    return origins, np.tile(dirs, (num_waypoints, 1))
