"""Vectorized PLY codecs (no Open3D dependency).

The reference delegates all mesh / point-cloud I/O to Open3D's C++ codecs and
hand-rolls a per-point ``struct.pack`` Python loop for its labeled export
(reference: containers/s3dis_sim_scene.py:614-641 writer,
lidar_net_bbox_visualizer.py:55-161 reader).  Here every path is a single
``numpy`` structured-array ``tofile``/``frombuffer`` — orders of magnitude
faster and byte-identical on the labeled format.

An optional C++ fast path (``native/ply_codec.cc``, loaded through ctypes) is
used transparently when the shared library has been built; the numpy path is
always available as a fallback.

Supported formats
-----------------
- ``binary_little_endian 1.0`` and ``ascii 1.0`` readers for arbitrary vertex
  properties plus triangle ``face`` elements.
- Labeled point cloud:  x,y,z float32 | red,green,blue uint8 | sem,ins uint16
  (bit-exact with the reference writer so downstream VoteNet/Group-Free-3D
  tooling consumes outputs unchanged).
- Generic point cloud / triangle mesh writers.
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

_PLY_TO_NUMPY = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_NUMPY_TO_PLY = {
    np.dtype(np.int8): "char",
    np.dtype(np.uint8): "uchar",
    np.dtype(np.int16): "short",
    np.dtype(np.uint16): "ushort",
    np.dtype(np.int32): "int",
    np.dtype(np.uint32): "uint",
    np.dtype(np.float32): "float",
    np.dtype(np.float64): "double",
}


@dataclass
class PlyElement:
    """One PLY element (e.g. ``vertex`` / ``face``) parsed from a file."""

    name: str
    count: int
    # scalar properties: list of (name, numpy dtype str); list properties:
    # (name, count dtype str, value dtype str)
    properties: List[Tuple] = field(default_factory=list)
    data: Optional[Dict[str, np.ndarray]] = None


@dataclass
class PlyFile:
    """Parsed PLY contents: ordered elements keyed by name."""

    elements: Dict[str, PlyElement]
    fmt: str  # "binary_little_endian" | "ascii"

    def vertex_array(self, names: Tuple[str, ...]) -> np.ndarray:
        v = self.elements["vertex"].data
        return np.stack([v[n] for n in names], axis=1)


def _parse_header(f) -> Tuple[PlyFile, int]:
    """Parse a PLY header from an open binary file; returns structure + offset."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("Not a PLY file (missing 'ply' magic).")
    fmt = None
    elements: Dict[str, PlyElement] = {}
    current: Optional[PlyElement] = None
    while True:
        raw = f.readline()
        if not raw:
            raise ValueError("Unexpected EOF while reading PLY header.")
        line = raw.decode("ascii", errors="replace").strip()
        if not line or line.startswith("comment") or line.startswith("obj_info"):
            continue
        if line == "end_header":
            break
        tokens = line.split()
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            current = PlyElement(name=tokens[1], count=int(tokens[2]))
            elements[tokens[1]] = current
        elif tokens[0] == "property":
            if current is None:
                raise ValueError("PLY property before any element.")
            if tokens[1] == "list":
                current.properties.append(
                    (tokens[4], _PLY_TO_NUMPY[tokens[2]], _PLY_TO_NUMPY[tokens[3]])
                )
            else:
                current.properties.append((tokens[2], _PLY_TO_NUMPY[tokens[1]]))
    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"Unsupported PLY format: {fmt}")
    return PlyFile(elements=elements, fmt=fmt), f.tell()


def _element_dtype(elem: PlyElement) -> Optional[np.dtype]:
    """Structured dtype for an element with only scalar properties."""
    fields = []
    for prop in elem.properties:
        if len(prop) != 2:
            return None
        name, dt = prop
        fields.append((name, "<" + dt))
    return np.dtype(fields)


def _read_binary_elements(f, ply: PlyFile) -> None:
    for elem in ply.elements.values():
        dtype = _element_dtype(elem)
        if dtype is not None:
            buf = f.read(dtype.itemsize * elem.count)
            arr = np.frombuffer(buf, dtype=dtype, count=elem.count)
            elem.data = {name: np.ascontiguousarray(arr[name]) for name in dtype.names}
            continue
        # List properties (faces).  Fast path: assume a uniform list length by
        # peeking at the first record; verify while parsing and fall back to a
        # record-by-record scan on ragged inputs.
        elem.data = _read_binary_list_element(f, elem)


def _read_binary_list_element(f, elem: PlyElement) -> Dict[str, np.ndarray]:
    if len(elem.properties) != 1 or len(elem.properties[0]) != 3:
        raise ValueError(
            f"Unsupported PLY element '{elem.name}' mixing list/scalar properties."
        )
    name, cnt_dt, val_dt = elem.properties[0]
    cnt_dtype = np.dtype("<" + cnt_dt)
    val_dtype = np.dtype("<" + val_dt)
    if elem.count == 0:
        return {name: np.zeros((0, 3), dtype=val_dtype)}
    start = f.tell()
    first_n = int(np.frombuffer(f.read(cnt_dtype.itemsize), dtype=cnt_dtype)[0])
    f.seek(start)
    rec_size = cnt_dtype.itemsize + first_n * val_dtype.itemsize
    buf = f.read(rec_size * elem.count)
    if len(buf) == rec_size * elem.count:
        rec = np.dtype([("n", cnt_dtype), ("v", val_dtype, (first_n,))])
        arr = np.frombuffer(buf, dtype=rec, count=elem.count)
        if np.all(arr["n"] == first_n):
            return {name: np.ascontiguousarray(arr["v"])}
    # Ragged fallback
    f.seek(start)
    rows = []
    for _ in range(elem.count):
        n = int(np.frombuffer(f.read(cnt_dtype.itemsize), dtype=cnt_dtype)[0])
        rows.append(np.frombuffer(f.read(n * val_dtype.itemsize), dtype=val_dtype))
    return {name: rows}


def _read_ascii_elements(f, ply: PlyFile) -> None:
    lines = f.read().decode("ascii").split("\n")
    idx = 0
    for elem in ply.elements.values():
        dtype = _element_dtype(elem)
        chunk = lines[idx: idx + elem.count]
        idx += elem.count
        if dtype is not None:
            arr = np.loadtxt(_io.StringIO("\n".join(chunk)), ndmin=2)
            elem.data = {
                name: arr[:, i].astype(dtype[name])
                for i, name in enumerate(dtype.names)
            }
        else:
            name, _, val_dt = elem.properties[0]
            rows = []
            for line in chunk:
                toks = line.split()
                n = int(toks[0])
                rows.append(np.array(toks[1: 1 + n], dtype="<" + val_dt))
            if rows and all(len(r) == len(rows[0]) for r in rows):
                elem.data = {name: np.stack(rows)}
            else:
                elem.data = {name: rows}


def read_ply(path: Union[str, Path]) -> PlyFile:
    """Parse a PLY file (binary little-endian or ascii) into arrays."""
    path = Path(path)
    with open(path, "rb") as f:
        ply, _ = _parse_header(f)
        if ply.fmt == "binary_little_endian":
            _read_binary_elements(f, ply)
        else:
            _read_ascii_elements(f, ply)
    return ply


# --------------------------------------------------------------------------
# Point clouds
# --------------------------------------------------------------------------

def read_point_cloud(path: Union[str, Path]):
    """Read points (+ optional colors/normals) from a PLY file.

    Returns
    -------
    points : (N, 3) float64
    colors : (N, 3) float64 in [0, 1] or None
    normals : (N, 3) float64 or None
    """
    ply = read_ply(path)
    if "vertex" not in ply.elements:
        raise ValueError(f"PLY has no vertex element: {path}")
    v = ply.elements["vertex"].data
    points = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    colors = None
    if all(k in v for k in ("red", "green", "blue")):
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        colors = (
            rgb.astype(np.float64) / 255.0
            if rgb.dtype.kind in "iu"
            else rgb.astype(np.float64)
        )
    normals = None
    if all(k in v for k in ("nx", "ny", "nz")):
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float64)
    return points, colors, normals


def write_point_cloud(
    path: Union[str, Path],
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    coord_dtype: str = "float",
) -> None:
    """Write a binary little-endian PLY point cloud.

    ``colors`` are accepted either as float in [0, 1] or as uint8.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    points = np.asarray(points)
    n = len(points)
    cdt = "f8" if coord_dtype == "double" else "f4"
    fields = [("x", "<" + cdt), ("y", "<" + cdt), ("z", "<" + cdt)]
    if normals is not None:
        fields += [("nx", "<" + cdt), ("ny", "<" + cdt), ("nz", "<" + cdt)]
    if colors is not None:
        fields += [("red", "<u1"), ("green", "<u1"), ("blue", "<u1")]
    rec = np.empty(n, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        normals = np.asarray(normals)
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        colors = np.asarray(colors)
        if colors.dtype.kind == "f":
            colors = np.clip(colors * 255.0 + 0.5, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = colors[:, 0], colors[:, 1], colors[:, 2]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [
        f"property {_NUMPY_TO_PLY[np.dtype(cdt)]} {f}"
        for f in ("x", "y", "z")
    ]
    if normals is not None:
        header += [
            f"property {_NUMPY_TO_PLY[np.dtype(cdt)]} {f}"
            for f in ("nx", "ny", "nz")
        ]
    if colors is not None:
        header += [f"property uchar {f}" for f in ("red", "green", "blue")]
    header.append("end_header")
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)


# --------------------------------------------------------------------------
# Labeled 8-attribute point cloud (reference interchange format)
# --------------------------------------------------------------------------

_LABELED_DTYPE = np.dtype(
    [
        ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
        ("red", "<u1"), ("green", "<u1"), ("blue", "<u1"),
        ("sem", "<u2"), ("ins", "<u2"),
    ]
)


def write_labeled_ply(
    path: Union[str, Path],
    points: np.ndarray,
    colors_u8: np.ndarray,
    semantic_labels: np.ndarray,
    instance_labels: np.ndarray,
) -> None:
    """Write the 8-attribute labeled PLY, byte-identical with the reference
    writer (containers/s3dis_sim_scene.py:614-641): header lines and the
    little-endian ``<fffBBBHH`` record layout match exactly, but the payload
    is emitted with one vectorized ``tofile`` instead of a per-point loop.
    """
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    n = len(points)
    points = np.asarray(points, dtype=np.float32)
    colors_u8 = np.asarray(colors_u8)
    if colors_u8.dtype != np.uint8:
        colors_u8 = colors_u8.astype(np.uint8)
    sem = np.asarray(semantic_labels).astype(np.uint16)
    ins = np.asarray(instance_labels).astype(np.uint16)

    # Native single-pass record interleave when the C++ library is built.
    from ipcgen_tpu_torch.utils import native

    payload = native.encode_labeled_payload(points, colors_u8, sem, ins)
    if payload is None:
        rec = np.empty(n, dtype=_LABELED_DTYPE)
        rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
        rec["red"], rec["green"], rec["blue"] = (
            colors_u8[:, 0], colors_u8[:, 1], colors_u8[:, 2],
        )
        rec["sem"] = sem
        rec["ins"] = ins
        payload = rec.tobytes()
    with open(path, "wb") as f:
        f.write(b"ply\n")
        f.write(b"format binary_little_endian 1.0\n")
        f.write(b"element vertex %d\n" % n)
        f.write(b"property float x\n")
        f.write(b"property float y\n")
        f.write(b"property float z\n")
        f.write(b"property uchar red\n")
        f.write(b"property uchar green\n")
        f.write(b"property uchar blue\n")
        f.write(b"property ushort sem\n")
        f.write(b"property ushort ins\n")
        f.write(b"end_header\n")
        f.write(payload)


def read_labeled_ply(path: Union[str, Path]):
    """Read the 8-attribute labeled PLY (vectorized counterpart of the
    reference's struct.unpack loop, lidar_net_bbox_visualizer.py:55-161).

    Returns
    -------
    points : (N, 3) float32
    colors : (N, 3) uint8
    semantic_labels : (N,) uint16
    instance_labels : (N,) uint16
    """
    ply = read_ply(path)
    v = ply.elements["vertex"].data
    if "sem" not in v or "ins" not in v:
        raise ValueError(
            f"PLY {path} lacks sem/ins attributes (expected x,y,z,r,g,b,sem,ins)."
        )
    points = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    colors = np.stack([v["red"], v["green"], v["blue"]], axis=1).astype(np.uint8)
    return points, colors, v["sem"].astype(np.uint16), v["ins"].astype(np.uint16)


# --------------------------------------------------------------------------
# Triangle meshes
# --------------------------------------------------------------------------

def read_triangle_mesh(path: Union[str, Path]):
    """Read a triangle mesh PLY.

    Returns
    -------
    vertices : (V, 3) float64
    triangles : (T, 3) int32
    vertex_colors : (V, 3) float64 in [0, 1] or None
    """
    ply = read_ply(path)
    points, colors, _ = _vertex_from_ply(ply)
    tris = np.zeros((0, 3), dtype=np.int32)
    if "face" in ply.elements:
        face = ply.elements["face"].data
        idx = next(iter(face.values()))
        if isinstance(idx, list):  # ragged: triangulate fans
            fans = []
            for row in idx:
                for k in range(1, len(row) - 1):
                    fans.append([row[0], row[k], row[k + 1]])
            tris = np.asarray(fans, dtype=np.int32)
        else:
            idx = np.asarray(idx)
            if idx.shape[1] == 3:
                tris = idx.astype(np.int32)
            else:  # quads etc: fan triangulation
                fans = []
                for k in range(1, idx.shape[1] - 1):
                    fans.append(
                        np.stack([idx[:, 0], idx[:, k], idx[:, k + 1]], axis=1)
                    )
                tris = np.concatenate(fans, axis=0).astype(np.int32)
    return points, tris, colors


def _vertex_from_ply(ply: PlyFile):
    v = ply.elements["vertex"].data
    points = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    colors = None
    if all(k in v for k in ("red", "green", "blue")):
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        colors = (
            rgb.astype(np.float64) / 255.0
            if rgb.dtype.kind in "iu"
            else rgb.astype(np.float64)
        )
    return points, colors, None


def write_triangle_mesh(
    path: Union[str, Path],
    vertices: np.ndarray,
    triangles: np.ndarray,
    vertex_colors: Optional[np.ndarray] = None,
    vertex_normals: Optional[np.ndarray] = None,
) -> None:
    """Write a binary little-endian triangle mesh PLY."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    vertices = np.asarray(vertices)
    triangles = np.asarray(triangles, dtype=np.int32)
    nv, nt = len(vertices), len(triangles)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if vertex_normals is not None:
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if vertex_colors is not None:
        fields += [("red", "<u1"), ("green", "<u1"), ("blue", "<u1")]
    rec = np.empty(nv, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = vertices[:, 0], vertices[:, 1], vertices[:, 2]
    if vertex_normals is not None:
        vn = np.asarray(vertex_normals)
        rec["nx"], rec["ny"], rec["nz"] = vn[:, 0], vn[:, 1], vn[:, 2]
    if vertex_colors is not None:
        vc = np.asarray(vertex_colors)
        if vc.dtype.kind == "f":
            vc = np.clip(vc * 255.0 + 0.5, 0, 255).astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = vc[:, 0], vc[:, 1], vc[:, 2]
    face_rec = np.empty(
        nt, dtype=np.dtype([("n", "<u1"), ("v", "<i4", (3,))])
    )
    face_rec["n"] = 3
    face_rec["v"] = triangles
    header = [
        "ply",
        "format binary_little_endian 1.0",
        f"element vertex {nv}",
        "property float x",
        "property float y",
        "property float z",
    ]
    if vertex_normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
    if vertex_colors is not None:
        header += [
            "property uchar red",
            "property uchar green",
            "property uchar blue",
        ]
    header += [
        f"element face {nt}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        rec.tofile(f)
        face_rec.tofile(f)
