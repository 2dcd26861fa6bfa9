"""The benchmark's traffic generator: furnished offices made from a seed.

Every room is a 6 x 5 x 2.5 m office holding 12 furniture boxes of fixed
sizes (``FURNITURE_SIZES``), ordered and placed by the room's seed.  It
comes in two forms that share the same surfaces:

- a triangle mesh of the inward room box and the outward furniture boxes
  as the sim stage gets it from the pipeline's recon: cut by marching
  tetrahedra on a grid of the recon's voxel (``Room.recon_mesh``), about
  1.4 M triangles at 3 cm, every vertex on its surface; written as a
  binary PLY;
- an S3DIS-layout TLS scan (``<room>.txt`` with ``x y z r g b`` rows and
  ``Annotations/<class>_<k>.txt`` per instance) with scanner noise and far
  outliers, the input of the preprocess stage and of the label transfer.

The scan and the S3DIS layout are frozen copies of the program's own
generators (``ipcgen_tpu_torch/utils/synthetic.py``: ``furniture_boxes``,
``synthetic_room``, ``write_s3dis_room``), kept here so that no change to
the program can move the traffic.  Departures: the furniture's sizes are
fixed, so that every seed gives the same work; the draws come from one
``numpy.random.Generator`` per room (``room_rng``); the mesh is cut as the
recon cuts it rather than subdivided; and the text tables are written by a
fixed-width formatter (``row_bytes``) instead of ``np.savetxt``, with the
same values (``%.3f`` coordinates, integer colours) padded by spaces.

The reference (``benchmark/reference.py``) takes the base triangles, the
boxes and the TLS arrays from here, never from the program.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

ROOM_CENTER = (3.0, 2.5, 1.25)
ROOM_SIZE = (6.0, 5.0, 2.5)
N_FURNITURE = 12
# The furniture's (x, y, z) sizes in metres, the same in every room so that
# every seed gives the same surface area to mesh, scan and label: 12 draws
# of the program's uniform 0.3 .. 1.2 m (numpy's generator seeded 0).
FURNITURE_SIZES = np.round(np.random.default_rng(0).uniform(0.3, 1.2, (N_FURNITURE, 3)), 3)
FURNITURE_CLASSES = ("table", "chair", "sofa", "bookcase")
CLASS_COLORS = {
    "ceiling": (200, 200, 200), "floor": (120, 100, 80), "wall": (180, 170, 150),
    "table": (150, 90, 40), "chair": (60, 60, 160), "sofa": (160, 40, 40),
    "bookcase": (90, 60, 20),
}
OUTLIER_RGB = (255, 0, 255)
# The S3DIS 13-class ids (Armeni et al., CVPR 2016; the order of the
# dataset's class list).
S3DIS_CLASS_IDS = {
    "ceiling": 0, "floor": 1, "wall": 2, "beam": 3, "column": 4, "window": 5,
    "door": 6, "table": 7, "chair": 8, "sofa": 9, "bookcase": 10, "board": 11,
    "clutter": 12,
}

# An axis-aligned box: corner signs and its 12 triangles, outward winding.
_BOX_CORNERS = np.array([
    [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
    [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
], dtype=np.float64)
_BOX_FACES = np.array([
    [0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7], [0, 1, 5], [0, 5, 4],
    [2, 3, 7], [2, 7, 6], [0, 4, 7], [0, 7, 3], [1, 2, 6], [1, 6, 5],
], dtype=np.int64)


def room_rng(seed: int, k: int) -> np.random.Generator:
    """The generator of room ``k`` of a run seeded ``seed`` (any integer)."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), int(k)]))


def _box(center, size, inward: bool = False):
    verts = np.asarray(center, np.float64) + _BOX_CORNERS * np.asarray(size, np.float64) / 2
    faces = _BOX_FACES[:, [0, 2, 1]] if inward else _BOX_FACES
    return verts, faces


def _breaks(lo: float, hi: float, h: float, f: float) -> np.ndarray:
    """The grid's cuts along one axis of a face: the cell walls
    ``(k + 1/2) h`` and the section's inner lines ``(k + 1/2 + f) h``
    inside ``(lo, hi)``, and the face's own ends; cuts closer than a
    micrometre merge."""
    ks = np.arange(np.floor(lo / h) - 1, np.ceil(hi / h) + 1) + 0.5
    cuts = np.sort(np.concatenate([ks * h, (ks + f) * h]))
    cuts = cuts[(cuts > lo + 1e-6) & (cuts < hi - 1e-6)]
    cuts = cuts[np.concatenate([[True], np.diff(cuts) > 1e-6])] if len(cuts) else cuts
    return np.concatenate([[lo], cuts, [hi]])


def grid_face(axis: int, c: float, lo, hi, normal_sign: int, h: float):
    """One axis-aligned rectangle (``axis`` = ``c``, the other two axes
    from ``lo`` to ``hi``) triangulated as marching tetrahedra cut it on
    a grid of cell ``h`` with six tetrahedra to a cube around the main
    diagonal: each cell holds the section's 8 triangles, slivers where the
    face passes near a cell wall.  The grid's cell walls lie at odd
    multiples of ``h / 2``, so the room's own walls, at whole metres and
    half metres, cut their cells at mid-depth, as the walls of a recon
    grid laid from a noisy cloud's bounds do somewhere inside a cell.  (vertices (V, 3) float64, triangles
    (T, 3) int64), the winding facing ``normal_sign`` along ``axis``."""
    a, b = [k for k in range(3) if k != axis]
    f = float((c / h - 0.5) % 1.0)
    ua = _breaks(lo[a], hi[a], h, f)
    ub = _breaks(lo[b], hi[b], h, f)
    na, nb = len(ua), len(ub)
    verts = np.empty((na * nb, 3))
    verts[:, axis] = c
    verts[:, a] = np.repeat(ua, nb)
    verts[:, b] = np.tile(ub, na)
    i, j = np.meshgrid(np.arange(na - 1), np.arange(nb - 1), indexing="ij")
    v00 = (i * nb + j).ravel()
    v10, v11, v01 = v00 + nb, v00 + nb + 1, v00 + 1
    tris = np.concatenate([np.stack([v00, v10, v11], 1), np.stack([v00, v11, v01], 1)])
    # e_a x e_b points along +axis when (a, b, axis) is cyclic.
    if (1 if (axis - a) % 3 == 2 else -1) != normal_sign:
        tris = tris[:, [0, 2, 1]]
    return verts, tris


@dataclass
class Room:
    """One office: its furniture as (center, size) boxes."""

    boxes: List[Tuple[Tuple[float, ...], Tuple[float, ...]]]

    @classmethod
    def draw(cls, rng: np.random.Generator) -> "Room":
        """The furniture of ``FURNITURE_SIZES`` in an order and at places
        drawn from ``rng``."""
        boxes = []
        for k in rng.permutation(N_FURNITURE):
            cx, cy = rng.uniform(0.5, 5.5), rng.uniform(0.5, 4.5)
            sx, sy, sz = (float(x) for x in FURNITURE_SIZES[k])
            boxes.append(((cx, cy, sz / 2), (sx, sy, sz)))
        return cls(boxes)

    def base_mesh(self):
        """(vertices float64, triangles int64): 12 triangles per box."""
        parts = [_box(ROOM_CENTER, ROOM_SIZE, inward=True)]
        parts += [_box(c, s) for c, s in self.boxes]
        verts, tris, off = [], [], 0
        for v, f in parts:
            verts.append(v)
            tris.append(f + off)
            off += len(v)
        return np.concatenate(verts), np.concatenate(tris)

    def base_triangles(self) -> np.ndarray:
        """(156, 3, 3) float64 corners of the room's surfaces, which the
        recon mesh cuts finer without moving them."""
        v, t = self.base_mesh()
        return v[t]

    def recon_mesh(self, voxel: float):
        """(vertices float32, triangles int32): the base mesh's surfaces
        (the inward room box and the outward furniture boxes) as marching
        tetrahedra at ``voxel`` cut them (``grid_face``), every vertex on
        its surface's plane."""
        boxes = [(ROOM_CENTER, ROOM_SIZE, -1)] + [(c, s, 1) for c, s in self.boxes]
        verts, tris, off = [], [], 0
        for center, size, outward in boxes:
            lo = np.asarray(center, np.float64) - np.asarray(size, np.float64) / 2
            hi = np.asarray(center, np.float64) + np.asarray(size, np.float64) / 2
            for axis in range(3):
                for side, c in ((-1, lo[axis]), (1, hi[axis])):
                    v, t = grid_face(axis, c, lo, hi, side * outward, voxel)
                    verts.append(v)
                    tris.append(t + off)
                    off += len(v)
        return (np.concatenate(verts).astype(np.float32),
                np.concatenate(tris).astype(np.int32))

    def surfaces(self):
        """[(instance name, [(origin, u, v), ...])]: the shell and the
        furniture faces (a box's floor face is left out: it stands on the
        floor)."""
        w, d, h = ROOM_SIZE
        out = [
            ("floor_1", [((0, 0, 0), (w, 0, 0), (0, d, 0))]),
            ("ceiling_1", [((0, 0, h), (w, 0, 0), (0, d, 0))]),
            ("wall_1", [((0, 0, 0), (w, 0, 0), (0, 0, h))]),
            ("wall_2", [((0, d, 0), (w, 0, 0), (0, 0, h))]),
            ("wall_3", [((0, 0, 0), (0, d, 0), (0, 0, h))]),
            ("wall_4", [((w, 0, 0), (0, d, 0), (0, 0, h))]),
        ]
        counts: Dict[str, int] = {}
        for k, (center, size) in enumerate(self.boxes):
            cls = FURNITURE_CLASSES[k % len(FURNITURE_CLASSES)]
            counts[cls] = counts.get(cls, 0) + 1
            lo = np.asarray(center) - np.asarray(size) / 2
            faces = []
            for axis in range(3):
                for side in (0, 1):
                    if axis == 2 and side == 0:
                        continue
                    a1, a2 = [a for a in range(3) if a != axis]
                    u, v = np.zeros(3), np.zeros(3)
                    u[a1], v[a2] = size[a1], size[a2]
                    origin = lo.copy()
                    origin[axis] += side * size[axis]
                    faces.append((origin, u, v))
            out.append((f"{cls}_{counts[cls]}", faces))
        return out


@dataclass
class TLS:
    """An S3DIS-layout scan: per instance its millimetre coordinates and
    colours, and the far outliers that only the room table holds."""

    instances: Dict[str, Tuple[np.ndarray, np.ndarray]]  # name -> (mm (n,3) int64, rgb (n,3))
    outliers_mm: np.ndarray  # (m, 3) int64

    def labeled_points(self):
        """(points float64 metres, semantic ids, instance ids) of the
        annotation files, in the layout's own meaning: the class is the
        name before the last ``_``, the instance the number after it."""
        pts, sem, ins = [], [], []
        for name, (mm, _) in self.instances.items():
            cls, k = name.rsplit("_", 1)
            pts.append(mm / 1000.0)
            sem.append(np.full(len(mm), S3DIS_CLASS_IDS[cls], np.int64))
            ins.append(np.full(len(mm), int(k), np.int64))
        return np.concatenate(pts), np.concatenate(sem), np.concatenate(ins)


def _rect(rng, n, origin, u, v):
    ab = rng.uniform(0.0, 1.0, (n, 2))
    return np.asarray(origin, float) + ab[:, :1] * np.asarray(u, float) \
        + ab[:, 1:] * np.asarray(v, float)


def _far_outliers(rng, n: int, margin: float = 0.25, pad: float = 1.5) -> np.ndarray:
    """``n`` points uniform in the room's box grown by ``pad`` metres, none
    within ``margin`` of the room's box."""
    lo, hi = -pad, np.asarray(ROOM_SIZE) + pad
    out = np.zeros((0, 3))
    while len(out) < n:
        p = rng.uniform(lo, hi, (2 * n + 16, 3))
        inside = np.all((p > -margin) & (p < np.asarray(ROOM_SIZE) + margin), axis=1)
        out = np.vstack([out, p[~inside]])
    return out[:n]


def scan_room(room: Room, rng: np.random.Generator, n_points: int,
              noise_std: float, outlier_frac: float) -> TLS:
    """About ``n_points`` surface samples spread by area, with Gaussian
    noise of ``noise_std`` metres, rounded to millimetres, plus
    ``outlier_frac`` of far outliers."""
    surfaces = room.surfaces()
    area = lambda u, v: float(np.linalg.norm(np.cross(u, v)))
    total = sum(area(u, v) for _, faces in surfaces for _, u, v in faces)
    instances = {}
    for name, faces in surfaces:
        pts = np.vstack([
            _rect(rng, max(int(n_points * area(u, v) / total), 16), o, u, v)
            for o, u, v in faces
        ])
        if noise_std > 0:
            pts = pts + rng.normal(0.0, noise_std, pts.shape)
        base = np.asarray(CLASS_COLORS[name.rsplit("_", 1)[0]])
        rgb = np.clip(base + rng.integers(-12, 13, (len(pts), 3)), 0, 255)
        instances[name] = (np.rint(pts * 1000.0).astype(np.int64), rgb.astype(np.int64))
    n_surface = sum(len(mm) for mm, _ in instances.values())
    far = _far_outliers(rng, int(round(outlier_frac * n_surface)))
    return TLS(instances, np.rint(far * 1000.0).astype(np.int64))


def _table(n: int, width: int, zeros: bool) -> np.ndarray:
    """(n, width) ASCII of 0 .. n-1, right-aligned; leading positions '0'
    with ``zeros``, else spaces (one digit at least)."""
    text = [(f"{k:0{width}d}" if zeros else f"{k:{width}d}").encode() for k in range(n)]
    return np.frombuffer(b"".join(text), np.uint8).reshape(n, width)


_INT4, _FRAC3, _BYTE3 = _table(10000, 4, False), _table(1000, 3, True), _table(256, 3, False)


def row_bytes(mm: np.ndarray, rgb: np.ndarray) -> np.ndarray:
    """(n, 40) ASCII of ``x y z r g b`` lines: coordinates in metres with
    three decimals (from millimetre ints, |x| < 1000 m), colours as
    integers, each field right-aligned after a space."""
    n = len(mm)
    out = np.full((n, 40), ord(" "), np.uint8)
    for a in range(3):
        v = mm[:, a]
        av = np.abs(v)
        ip = av // 1000
        col = 9 * a
        out[:, col + 1:col + 5] = _INT4[ip]
        nd = 1 + (ip >= 10) + (ip >= 100)
        neg = np.flatnonzero(v < 0)
        out[neg, col + 4 - nd[neg]] = ord("-")
        out[:, col + 5] = ord(".")
        out[:, col + 6:col + 9] = _FRAC3[av % 1000]
    for a in range(3):
        out[:, 28 + 4 * a:31 + 4 * a] = _BYTE3[rgb[:, a]]
    out[:, 39] = ord("\n")
    return out


def write_tls(room_dir: Path, tls: TLS, rng: np.random.Generator) -> int:
    """``room_dir/room.txt`` (every row, shuffled) and
    ``room_dir/Annotations/<name>.txt``; returns the room's row count."""
    ann = Path(room_dir) / "Annotations"
    ann.mkdir(parents=True, exist_ok=True)
    rows = []
    for name, (mm, rgb) in tls.instances.items():
        rows.append(row_bytes(mm, rgb))
        (ann / f"{name}.txt").write_bytes(rows[-1].tobytes())
    rows.append(row_bytes(tls.outliers_mm, np.tile(np.asarray(OUTLIER_RGB, np.int64),
                                                   (len(tls.outliers_mm), 1))))
    rows = np.concatenate(rows)
    order = rng.permutation(len(rows))
    (Path(room_dir) / "room.txt").write_bytes(rows[order].tobytes())
    return len(rows)


def write_mesh_ply(path: Path, verts: np.ndarray, tris: np.ndarray) -> None:
    """A binary little-endian triangle-mesh PLY."""
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(tris)}\n"
        "property list uchar int vertex_indices\nend_header\n"
    ).encode()
    faces = np.empty(len(tris), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    faces["n"] = 3
    faces["i"] = tris
    with open(path, "wb") as f:
        f.write(header)
        f.write(np.ascontiguousarray(verts, "<f4").tobytes())
        f.write(faces.tobytes())


@dataclass
class PoolRoom:
    """A generated room on disk and in memory."""

    k: int
    room: Room
    tls: TLS
    tls_dir: Path
    mesh_path: Path = None
    triangles: int = 0


def make_pool(out: Path, seed: int, n_rooms: int, tls_points: int, noise_std: float,
              outlier_frac: float, mesh_voxel: float = 0.0) -> List[PoolRoom]:
    """``n_rooms`` rooms drawn from ``seed``: ``out/tls_<k>/`` each, and
    ``out/mesh_<k>.ply`` (``Room.recon_mesh``) when ``mesh_voxel`` is set."""
    pool = []
    for k in range(n_rooms):
        rng = room_rng(seed, k)
        room = Room.draw(rng)
        tls = scan_room(room, rng, tls_points, noise_std, outlier_frac)
        tls_dir = Path(out) / f"tls_{k}"
        write_tls(tls_dir, tls, rng)
        pr = PoolRoom(k, room, tls, tls_dir)
        if mesh_voxel:
            pr.mesh_path = Path(out) / f"mesh_{k}.ply"
            verts, tris = room.recon_mesh(mesh_voxel)
            pr.triangles = len(tris)
            write_mesh_ply(pr.mesh_path, verts, tris)
        pool.append(pr)
    return pool


def link_room(data_root: Path, area: str, room_name: str, pool_room: PoolRoom) -> Path:
    """``data_root/area/room_name`` in the S3DIS layout, its files links to
    the pool room's, so a fresh name costs no copy."""
    d = Path(data_root) / area / room_name
    d.mkdir(parents=True, exist_ok=True)
    os.symlink(pool_room.tls_dir / "room.txt", d / f"{room_name}.txt")
    os.symlink(pool_room.tls_dir / "Annotations", d / "Annotations")
    return d
