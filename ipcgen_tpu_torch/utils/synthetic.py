"""Synthetic scenes: a furnished room with a matching S3DIS-format TLS room,
and the small cluttered room the raycast kernels are checked on.

``synthetic_room`` is the mesh of ``scripts/bench_raycast.py:15-59`` (an
inward 6 x 5 x 2.5 m box with 12 furniture boxes, 1->4 subdivided towards a
target triangle count), copied here so that the port and ``chip_smoke.py``
need nothing outside the package.  ``write_s3dis_room`` samples points on the
same surfaces and writes them in the S3DIS layout the label path reads: the
room txt (``x y z r g b``) plus ``Annotations/{class}_{k}.txt``; with scanner
noise and far outliers, it is the preprocess stage's test room.

``cluttered_room``, ``hardware_rays`` and ``hardware_scene`` are the scene
and rays of ``tests/test_tpu_hardware.py:31-50``, shared by ``chip_smoke.py``
and the port's tests.

``patch_ordered_scan_rays`` is the ray set of
``scripts/bench_kernel_iter.py:21-36``, which the kernel probe
(``ipcgen_tpu_torch/kernel_probe.py``) casts.

``asset_edge_meshes`` are the meshes whose scene asset a build could get
wrong: ragged and tiny block counts, degenerate triangles, Morton ties and a
flat extent.
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
OUTLIER_RGB = (255, 0, 255)  # the far outliers' colour (write_s3dis_room)


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


def _far_outliers(rng, n: int, margin: float = 0.25, pad: float = 1.5) -> np.ndarray:
    """``n`` points uniform in the room's box grown by ``pad`` metres, none
    within ``margin`` of the room's box: far from every surface sample."""
    lo, hi = -pad, np.asarray(ROOM_SIZE) + pad
    out = np.zeros((0, 3))
    while len(out) < n:
        p = rng.uniform(lo, hi, (2 * n + 16, 3))
        inside = np.all((p > -margin) & (p < np.asarray(ROOM_SIZE) + margin), axis=1)
        out = np.vstack([out, p[~inside]])
    return out[:n]


def write_s3dis_room(room_dir, n_points: int = 600_000, seed: int = 0,
                     noise_std: float = 0.0, outlier_frac: float = 0.0) -> int:
    """Write ``{room}.txt`` and ``Annotations/*.txt`` for the synthetic room
    under ``room_dir`` (its last path part is the room name), with about
    ``n_points`` points spread over the surfaces by area.  Returns the count.

    ``noise_std`` (metres) adds Gaussian noise to every surface point;
    ``outlier_frac`` adds that share of far outliers (``_far_outliers``) to
    the room txt only, coloured ``OUTLIER_RGB``, which no surface takes.
    At their defaults the files are those written without them.
    """
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
        if noise_std > 0:
            pts = pts + rng.normal(0.0, noise_std, pts.shape)
        base = np.asarray(CLASS_COLORS[name.rsplit("_", 1)[0]])
        rgb = np.clip(base + rng.integers(-12, 13, (len(pts), 3)), 0, 255)
        r = np.hstack([np.round(pts, 3), rgb])
        np.savetxt(ann_dir / f"{name}.txt", r, fmt="%.3f %.3f %.3f %d %d %d")
        rows.append(r)
    if outlier_frac > 0:
        far = _far_outliers(rng, int(round(outlier_frac * sum(map(len, rows)))))
        rows.append(np.hstack([np.round(far, 3), np.tile(OUTLIER_RGB, (len(far), 1))]))
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


EDGE_T_MAX = 6.0
EDGE_KW = dict(block_size=2, super_factor=2)


def _tri(v0, e1, e2):
    v0 = np.asarray(v0, np.float32)
    return np.stack([v0, v0 + np.float32(e1), v0 + np.float32(e2)])


def culled_edge_cases(seed: int = 0):
    """The ray set that the culled kernel's walk and prescreen could get
    wrong: (vertices, triangles, origins, dirs, asset kwargs, t_max).

    Leaf blocks of 2 triangles and supers of 2 blocks (``EDGE_KW``), t_max
    ``EDGE_T_MAX``.  It holds:

    - ties: 12 random triangles, each 5 times, so the copies span leaf
      blocks and supers; rays from all around aim at them, so for some the
      super with the smaller slot is entered later;
    - hits at exactly t_max (t = 6, dropped) and one float below it;
    - origins on a leaf block's slab plane, with a zero and a non-zero
      direction component across it;
    - axis-aligned directions (zero components) throughout;
    - |det| within 3 float32 steps of 1e-9 either way (a thin triangle
      whose det is exactly its width);
    - t within a float32 step or two of another hit: parallel triangles
      stacked 1 to 3 float steps apart, axis-aligned (exact) and tilted.
    """
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_arrays

    rng = np.random.default_rng(seed)
    tris = []
    base = rng.uniform([0.5, 0.5, 1.0], [3.5, 3.5, 3.0], (12, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.25, (12, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.25, (12, 3)).astype(np.float32)
    dup_centers = []
    for b, a, c in zip(base, e1, e2):
        tris += [_tri(b, a, c)] * 5
        dup_centers.append(b + (a + c) / np.float32(3))
    # t exactly t_max at (10.5, 0.5) and one float32 step nearer at (12.5, 0.5).
    near = np.nextafter(np.float32(EDGE_T_MAX), np.float32(0))
    tris.append(_tri([10, 0, EDGE_T_MAX], [2, 0, 0], [0, 2, 0]))
    tris.append(_tri([12, 0, near], [2, 0, 0], [0, 2, 0]))
    # |det| = width exactly for rays along +z: widths 1e-9 -+ 3 steps.
    widths = [np.float32(1e-9)]
    for _ in range(3):
        widths = [np.nextafter(widths[0], np.float32(0))] + widths
        widths = widths + [np.nextafter(widths[-1], np.float32(1))]
    for k, w in enumerate(widths):
        tris.append(_tri([0, 20 + 2 * k, 1 + 0.25 * k], [w, 0, 0], [0, 1, 0]))
    # Parallel triangles 0-3 float32 steps above z = 3.
    zs = [np.float32(3.0)]
    for _ in range(3):
        zs.append(np.nextafter(zs[-1], np.float32(4)))
    for z in zs[::-1]:  # the nearest last: it gets the largest slot
        tris.append(_tri([30, 0, z], [1, 0, 0], [0, 1, 0]))
    verts = np.concatenate(tris).astype(np.float32)
    faces = np.arange(len(verts), dtype=np.int32).reshape(-1, 3)

    origins, dirs = [], []

    def add(o, d):
        d = np.asarray(d, np.float64)
        origins.append(np.asarray(o, np.float32))
        dirs.append((d / np.linalg.norm(d)).astype(np.float32))

    for c in dup_centers:  # ties, from 24 directions each
        for _ in range(24):
            u = rng.normal(size=3)
            u /= np.linalg.norm(u)
            add(c + 3.0 * u, -u)
    for k, w in enumerate(widths):  # thin triangles, hit at u = 0.25
        add([w / np.float32(4), 20.25 + 2 * k, 0], [0, 0, 1])
    for x in (10.5, 12.5):  # t = t_max and one step below
        add([x, 0.5, 0], [0, 0, 1])
        add([x, 0.5, 0], [0.01, 0.02, 1])
    for tilt in ([0, 0, 1], [0.01, 0.02, 1], [-0.003, 0.001, 1]):  # stacked
        for y in (0.1, 0.3, 0.45):
            add([30.4, y, 0], tilt)
    arrays = build_scene_arrays(verts, faces, **EDGE_KW)
    lo = arrays["block_lo"]
    for b in np.flatnonzero(np.isfinite(lo[:, 0]))[:12]:  # on a slab plane
        c = (lo[b] + arrays["block_hi"][b]) / 2
        for d in ([0, 0, 1], [0, 1, 0], [0, 0.6, 0.8], [1, 0, 0]):
            add([lo[b, 0], c[1], c[2] - 2.0 * d[2]], d)
    for d in ([1, 0, 0], [0, 1, 0], [0, 0, 1], [0, 0, -1], [-1, 0, 0]):  # axis-aligned
        for o in rng.uniform([0.0, 0.0, 0.0], [4.0, 4.0, 4.0], (8, 3)):
            add(o, d)
    return (verts, faces, np.stack(origins), np.stack(dirs), dict(EDGE_KW),
            EDGE_T_MAX)


def asset_edge_meshes(seed: int = 0):
    """{name: (vertices float64, triangles int32)} for the scene asset's
    builds (``ops/scene_asset.py``):

    - ``ragged``: 1,000 random triangles, not a multiple of 128;
    - ``few_blocks``: 300, three leaf blocks of 128, within the bucketing's
      granularity of 4;
    - ``single``: one triangle;
    - ``zero_area``: 200 triangles, half of them with two equal corners or
      collinear ones (zero normals);
    - ``equal_centroids``: 400 triangles in 25 groups of 16 that share a
      centroid (each group one triangle turned about it), so their Morton
      codes tie;
    - ``flat``: 500 triangles with every z equal, an extent under 1e-9 on
      that axis.
    """
    rng = np.random.default_rng(seed)

    def soup(n, lo=(0.0, 0.0, 0.0), hi=(6.0, 5.0, 2.5), size=0.2):
        c = rng.uniform(lo, hi, (n, 1, 3)) + rng.uniform(-size, size, (n, 3, 3))
        return c.reshape(-1, 3), np.arange(3 * n, dtype=np.int32).reshape(-1, 3)

    out = {"ragged": soup(1000), "few_blocks": soup(300), "single": soup(1)}
    v, t = soup(200)
    c = v.reshape(-1, 3, 3)
    c[::4, 1] = c[::4, 0]  # two equal corners
    c[1::4, 2] = c[1::4, 0] + 2.0 * (c[1::4, 1] - c[1::4, 0])  # collinear
    out["zero_area"] = (c.reshape(-1, 3), t)
    centers = rng.uniform((0.0, 0.0, 0.0), (6.0, 5.0, 2.5), (25, 3))
    base = rng.uniform(-0.1, 0.1, (3, 3))
    base -= base.mean(axis=0)
    tris = []
    for ctr in centers:
        for k in range(16):
            a = 2.0 * np.pi * k / 16
            rot = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                            [0.0, 0.0, 1.0]])
            tris.append(ctr + base @ rot.T)
    out["equal_centroids"] = (np.concatenate(tris),
                              np.arange(3 * len(tris), dtype=np.int32).reshape(-1, 3))
    v, t = soup(500)
    v[:, 2] = 1.25
    out["flat"] = (v, t)
    return out
