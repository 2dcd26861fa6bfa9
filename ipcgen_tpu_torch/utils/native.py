"""ctypes bindings for the native host runtime (native/ipcgen_native.cc).

Every entry point degrades gracefully to a numpy implementation when the
shared library has not been built (``native/build.sh``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build_lib(src: Path, so: Path) -> bool:
    """Compile the native library from source (quiet best-effort).

    Writes to a per-process temp name and atomically renames so concurrent
    processes (pytest workers, parallel batch drivers) never dlopen a
    half-written .so; rename also makes the last writer win cleanly.
    """
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC",
             "-std=c++17", "-o", str(tmp), str(src)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, so)
        return so.is_file()
    except (OSError, subprocess.SubprocessError):
        try:
            tmp.unlink(missing_ok=True)
        except OSError:
            pass
        return False


def _find_lib() -> Optional[Path]:
    env = os.environ.get("IPCGEN_NATIVE_LIB", "")
    if env and Path(env).is_file():
        return Path(env)
    repo = Path(__file__).resolve().parents[2]
    src = repo / "native" / "ipcgen_native.cc"
    so = repo / "build" / "ipcgen_tpu_torch" / "libipcgen_native.so"
    # The binary is never committed: build it from source on first use and
    # rebuild whenever the source is newer, so the loaded code always matches
    # the reviewed .cc (an unauditable prebuilt .so can silently embed stale
    # bugs).  It goes to the port's own build directory, beside its kernels.
    if src.is_file():
        so.parent.mkdir(parents=True, exist_ok=True)
        stale = not so.is_file() or so.stat().st_mtime < src.stat().st_mtime
        if stale and not _build_lib(src, so):
            return None
    if so.is_file():
        return so
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (once) and return the native library, or None."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.parse_float_table.restype = ctypes.c_int
        lib.parse_float_table.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.morton_order.restype = None
        lib.morton_order.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.encode_labeled_payload.restype = None
        lib.encode_labeled_payload.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.POINTER(ctypes.c_uint16),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        _LIB = lib
    except OSError:
        _LIB = None
    return _LIB


def available() -> bool:
    return get_lib() is not None


def parse_float_table(path: str) -> Optional[np.ndarray]:
    """Fast parse of a whitespace-separated float table; None if unavailable.

    Replaces np.loadtxt for the multi-million-line S3DIS room files
    (reference load site: s3dis_data_loader.py:50).
    """
    lib = get_lib()
    if lib is None:
        return None
    rows = ctypes.c_int64(0)
    cols = ctypes.c_int64(0)
    rc = lib.parse_float_table(
        path.encode(), None, ctypes.byref(rows), ctypes.byref(cols)
    )
    if rc != 0 or rows.value == 0 or cols.value == 0:
        return None if rc != 0 else np.zeros((0, 0))
    alloc_rows, alloc_cols = rows.value, cols.value
    out = np.empty((alloc_rows, alloc_cols), dtype=np.float64)
    # Fill call: rows/cols carry the allocated capacity in and the actual
    # parsed counts out; validate against the allocation as a backstop.
    rc = lib.parse_float_table(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        ctypes.byref(rows),
        ctypes.byref(cols),
    )
    if rc != 0 or cols.value != alloc_cols or rows.value > alloc_rows:
        return None
    if rows.value < alloc_rows:
        out = out[: rows.value]
    return out


def morton_order(points: np.ndarray, bits: int = 10) -> Optional[np.ndarray]:
    """Stable Morton sort order of (N, 3) points; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(points, dtype=np.float32)
    lo = pts.min(axis=0)
    extent = np.maximum(pts.max(axis=0) - lo, 1e-9)
    inv = (1.0 / extent).astype(np.float32)
    lo = lo.astype(np.float32)
    order = np.empty(len(pts), dtype=np.int32)
    lib.morton_order(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(pts)),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        inv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int(bits),
        order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return order


def encode_labeled_payload(
    xyz: np.ndarray, rgb: np.ndarray, sem: np.ndarray, ins: np.ndarray
) -> Optional[bytes]:
    """Interleave the labeled-PLY payload records; None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xyz = np.ascontiguousarray(xyz, dtype=np.float32)
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    sem = np.ascontiguousarray(sem, dtype=np.uint16)
    ins = np.ascontiguousarray(ins, dtype=np.uint16)
    n = len(xyz)
    out = np.empty(n * 19, dtype=np.uint8)
    lib.encode_labeled_payload(
        xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        sem.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ins.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.tobytes()
