"""Build, bind and launch the hand-written CUDA kernels.

Each source in ``ipcgen_tpu_torch/csrc`` (``SOURCES``) is compiled on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
-fPIC`` plus its own flags into its own library under
``build/ipcgen_tpu_torch/`` at the repository root (the file name carries a
hash of the source and the command, so an edited kernel is rebuilt).  The
sources that are missing are compiled together, one ``nvcc`` process each.
Each library is bound with ``ctypes`` through a plain C interface: one
``<kernel>_launch`` function per kernel (``KERNELS``) and one
``<source>_error_string``; pointers and the current stream go in as
``c_void_p``, and each launch function returns ``cudaGetLastError()``.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs and scratch with ``torch.empty``, launches on the current stream
without synchronising (the prepass reads one total between its two passes),
raises if a launch was refused, and adds one to its kernel's entry of
``LAUNCHES``.  Nothing here falls back to another path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ipcgen_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# Source name -> its own nvcc flags.  The culled raycast, the exact 1-NN and
# the scene asset's build must round every product and sum on their own
# (bit-exact against the oracle, the plain version or the numpy build): no
# FMA contraction.
SOURCES = {
    "raycast_pairs": [],
    "raycast_culled": ["-fmad=false"],
    "raycast_probe": [],
    "nn_exact": ["-fmad=false"],
    "scene_asset": ["-fmad=false"],
}

_C_PTR, _C_INT, _C_FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Kernel name -> (its source, the argtypes of ``<kernel>_launch``).
KERNELS = {
    "raycast_pairs": ("raycast_pairs", [_C_PTR] * 12 + [_C_INT] * 4 + [_C_FLOAT, _C_PTR]),
    "raycast_pairs_prepass": ("raycast_pairs",
                              [_C_PTR] * 13 + [_C_INT] * 4 + [_C_FLOAT, _C_INT, _C_PTR]),
    "raycast_culled": ("raycast_culled",
                       [_C_PTR] * 9 + [_C_INT] * 5 + [_C_FLOAT, _C_PTR]),
    "raycast_culled_count": ("raycast_culled",
                             [_C_PTR] * 10 + [_C_INT] * 5 + [_C_FLOAT, _C_PTR]),
    "raycast_probe_call": ("raycast_probe",
                           [_C_PTR] * 10 + [_C_INT] * 4 + [_C_FLOAT, _C_PTR]),
    "raycast_probe_grid": ("raycast_probe",
                           [_C_PTR] * 7 + [_C_INT] * 2 + [_C_FLOAT, _C_PTR]),
    "raycast_probe_flat": ("raycast_probe",
                           [_C_PTR] * 7 + [_C_INT] * 2 + [_C_FLOAT, _C_PTR]),
    "nn_exact": ("nn_exact", [_C_PTR] * 3 + [_C_INT] * 4 + [_C_PTR]),
    "scene_codes": ("scene_asset", [_C_PTR] * 5 + [_C_INT] * 3 + [_C_PTR]),
    "scene_pack": ("scene_asset", [_C_PTR] * 12 + [_C_INT] * 5 + [_C_PTR]),
}

# Launch count per kernel, and of the prepass's counting launch under its own
# key (it never runs on the main path); a run resets these to 0 and reads
# them after.
LAUNCHES = {name: 0 for name in (*KERNELS, "raycast_pairs_prepass_count")}
# Seconds the last build of each source took (0.0 when it was already built).
BUILD_SECONDS = {}

_LIBS = {}
# The label threads launch the 1-NN kernel beside main's raycasts: one build
# at a time.
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found (set CUDA_HOME)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def nvcc_command(name: str, out: Path, nvcc: str = "nvcc") -> list:
    """The command that compiles ``csrc/<name>.cu`` into ``out``."""
    return [nvcc, *NVCC_FLAGS, *SOURCES[name], "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _library_path(name: str) -> Path:
    key = (CSRC / f"{name}.cu").read_bytes() + " ".join(
        NVCC_FLAGS + SOURCES[name]).encode()
    return BUILD_DIR / f"lib{name}_{hashlib.sha256(key).hexdigest()[:12]}.so"


def build() -> dict:
    """Compile every kernel source not built yet (all at once, one nvcc
    each), load each library once, and return them by kernel name."""
    if len(_LIBS) == len(SOURCES):
        return _LIBS
    with _BUILD_LOCK:
        return _build_locked()


def _build_locked() -> dict:
    if len(_LIBS) == len(SOURCES):
        return _LIBS
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        so = _library_path(name)
        BUILD_SECONDS.setdefault(name, 0.0)
        if name in _LIBS or so.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        procs[name] = (so, tmp, time.perf_counter(), subprocess.Popen(
            nvcc_command(name, tmp, nvcc), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (so, tmp, t0, proc) in procs.items():
        out, err = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}\n{err}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in SOURCES:
        if name in _LIBS:
            continue
        lib = ctypes.CDLL(str(_library_path(name)))
        for kernel, (source, argtypes) in KERNELS.items():
            if source == name:
                launch = getattr(lib, f"{kernel}_launch")
                launch.restype = ctypes.c_int
                launch.argtypes = argtypes
        error_string = getattr(lib, f"{name}_error_string")
        error_string.restype = ctypes.c_char_p
        error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return _LIBS


def _check(x: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: {x.dim()}-D, expected {ndim}-D")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(name: str, device: torch.device, *args, count: bool = True, lib=None) -> None:
    """Call kernel ``name``'s ``<name>_launch`` on the current stream of
    ``device``; raise if the launch was refused, else count it (unless
    ``count`` is False: the prepass counts its two passes once, itself).
    ``lib``: another build of the source (``kernel_probe --against``), never
    counted."""
    source = KERNELS[name][0]
    count = count and lib is None
    lib = build()[source] if lib is None else lib
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, f"{name}_launch")(*args, stream)
    if rc != 0:
        msg = getattr(lib, f"{source}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    if count:
        LAUNCHES[name] += 1


def raycast_pairs_prepass_cuda(origins, dirs, block_lo, block_hi, group_lo,
                               group_hi, group: int, t_max: float, n_sub: int):
    """Launch the exact pair prepass (csrc/raycast_pairs.cu: the count pass
    ``pairs_prepass_kernel``, then ``pairs_prepass_fill_kernel``): the exact
    candidate list of every 256-ray subtile, with no cap.

    origins, dirs (T * n_sub * 256, 3) float32; block_lo, block_hi (NB, 3)
    and group_lo, group_hi (ceil(NB / group), 3) float32 (the NaN-aware
    unions of ``group`` consecutive blocks); all on one CUDA device; n_sub in
    1, 2, 4, 8 and ``group`` a power of two up to 128.  The count pass (megas
    of 8 groups, then groups, then blocks) leaves one byte of subtile bits
    per (tile, block) in scratch (T x NB bytes, rows padded to 16); then CSR
    offsets by ``torch.cumsum`` and one host read of their total (it sizes
    the list), then the fill pass, which only compacts the bytes.  One launch
    is counted.  Returns (offsets (S+1,) int32, blocks (P,) int32 ascending
    per subtile, groups (T,) int32 block groups each tile crosses, union (T,)
    int32 blocks in the union of its subtiles' lists).
    """
    return _prepass(origins, dirs, block_lo, block_hi, group_lo, group_hi, group, t_max,
                    n_sub, counting=False)


# The counting launch's counts: the megas, groups and blocks the count pass
# considers (a NaN box is considered and skipped), each once for every ray
# of its tile, and the tiles that took the checked form.
PREPASS_COUNTS = ("mega_tests", "group_tests", "block_tests", "checked_tiles")


def raycast_pairs_prepass_count_cuda(origins, dirs, block_lo, block_hi, group_lo,
                                     group_hi, group: int, t_max: float, n_sub: int):
    """``raycast_pairs_prepass_cuda`` with the count pass's stage counts: the
    same four outputs plus a dict of ``PREPASS_COUNTS``.  Counted under
    ``LAUNCHES["raycast_pairs_prepass_count"]``; the main path never calls
    it."""
    return _prepass(origins, dirs, block_lo, block_hi, group_lo, group_hi, group, t_max,
                    n_sub, counting=True)


def _prepass(origins, dirs, block_lo, block_hi, group_lo, group_hi, group: int,
             t_max: float, n_sub: int, counting: bool):
    """The two passes of ``raycast_pairs_prepass_launch``, counted once per
    call in ``LAUNCHES``."""
    device = origins.device
    if device.type != "cuda":
        raise ValueError(f"raycast_pairs_prepass_cuda: origins is on {device}, not CUDA")
    for x, arg in ((origins, "origins"), (dirs, "dirs"), (block_lo, "block_lo"),
                   (block_hi, "block_hi"), (group_lo, "group_lo"), (group_hi, "group_hi")):
        _check(x, arg, torch.float32, 2, device)
    if n_sub not in (1, 2, 4, 8):
        raise ValueError(f"n_sub must be 1, 2, 4 or 8, got {n_sub}")
    if group not in (1, 2, 4, 8, 16, 32, 64, 128):
        raise ValueError(f"group must be a power of two up to 128, got {group}")
    tile = n_sub * 256
    n, nb = origins.shape[0], block_lo.shape[0]
    ng = -(-nb // group)
    if origins.shape != (n, 3) or dirs.shape != (n, 3) or n == 0 or n % tile:
        raise ValueError(f"origins/dirs: shapes {tuple(origins.shape)}, {tuple(dirs.shape)}, "
                         f"expected (T * {tile}, 3) each, T > 0")
    if nb == 0 or block_lo.shape != (nb, 3) or block_hi.shape != (nb, 3):
        raise ValueError("block_lo/block_hi: expected (NB, 3) each, NB > 0")
    if group_lo.shape != (ng, 3) or group_hi.shape != (ng, 3):
        raise ValueError(f"group_lo/group_hi: expected ({ng}, 3) for {nb} blocks of {group}")
    n_tiles = n // tile
    i32 = dict(dtype=torch.int32, device=device)
    sub_counts = torch.empty(n_tiles * n_sub, **i32)
    groups = torch.empty(n_tiles, **i32)
    union = torch.empty(n_tiles, **i32)
    rows = torch.empty(n_tiles * (-(-nb // 16) * 4), **i32)  # subtile bytes per block
    counts = torch.zeros(len(PREPASS_COUNTS), dtype=torch.int64, device=device) \
        if counting else None
    boxes = [x.data_ptr() for x in (origins, dirs, block_lo, block_hi, group_lo, group_hi)]
    sizes = (n_tiles, n_sub, nb, int(group), float(t_max))
    _launch("raycast_pairs_prepass", device, *boxes, sub_counts.data_ptr(), groups.data_ptr(),
            union.data_ptr(), rows.data_ptr(), None, None,
            counts.data_ptr() if counting else None, *sizes, 0, count=False)
    offsets = torch.zeros(n_tiles * n_sub + 1, dtype=torch.int64, device=device)
    offsets[1:] = torch.cumsum(sub_counts, 0)
    n_pairs = int(offsets[-1])  # the one host read: it sizes the pair list
    if n_pairs >= 2**31:
        raise ValueError(f"{n_pairs} pairs do not fit int32 offsets")
    offsets = offsets.to(torch.int32)
    blocks = torch.empty(n_pairs, **i32)
    _launch("raycast_pairs_prepass", device, *boxes, None, None, None, rows.data_ptr(),
            offsets.data_ptr(), blocks.data_ptr(), None, *sizes, 1, count=False)
    LAUNCHES["raycast_pairs_prepass_count" if counting else "raycast_pairs_prepass"] += 1
    if counting:
        return offsets, blocks, groups, union, dict(zip(PREPASS_COUNTS, counts.tolist()))
    return offsets, blocks, groups, union


def raycast_pairs_cuda(w: dict, f64_count=None):
    """Launch ``raycast_pairs_kernel`` (csrc/raycast_pairs.cu) over the flat
    pair list of ``w`` (``prepare_pairs``' dict, or one with its walk keys):
    subtile s walks ``blocks[offsets[s]:offsets[s+1]]``.

    ``f`` (S*256, 10) float32 features of the rays ``origins``, ``dirs``
    (S*256, 3) float32; ``trif`` (NB, 10, 5*TB) float32 panels of
    ``tri_data`` (NB, 16, TB) float32, ``radius`` (NB,) float32 their
    ``block_radius``; ``offsets`` (S+1,) int32 with offsets[0] = 0 and
    offsets[S] = P, ``blocks`` (P,) int32; all on one CUDA device; ``sub``
    must be 256; ``t_init`` the initial best t.  ``f64_count``: None, or a
    zeroed (1,) int64 tensor on the device to which the walk adds the
    (ray, triangle) tests whose edge test float64 decided.  Returns (t
    (S*256,) float32, +inf on a miss; slot (S*256,) int32, -1 on a miss).
    """
    f, trif, offsets, blocks = w["f"], w["trif"], w["offsets"], w["blocks"]
    origins, dirs, tri_data, radius = w["origins"], w["dirs"], w["tri_data"], w["radius"]
    sub = w["sub"]
    device = f.device
    if device.type != "cuda":
        raise ValueError(f"raycast_pairs_cuda: f is on {device}, not CUDA")
    _check(f, "f", torch.float32, 2, device)
    _check(trif, "trif", torch.float32, 3, device)
    _check(offsets, "offsets", torch.int32, 1, device)
    _check(blocks, "blocks", torch.int32, 1, device)
    for x, name, ndim in ((origins, "origins", 2), (dirs, "dirs", 2),
                          (tri_data, "tri_data", 3), (radius, "radius", 1)):
        _check(x, name, torch.float32, ndim, device)
    if f64_count is not None:
        _check(f64_count, "f64_count", torch.int64, 1, device)
    if sub != 256:
        raise ValueError(f"sub must be 256 (64 threads x 4 rays), got {sub}")
    n_subtiles = offsets.shape[0] - 1
    nb, n_feat, width = trif.shape
    if n_feat != 10 or width % 5 or nb == 0:
        raise ValueError(f"trif: shape {tuple(trif.shape)}, expected (NB, 10, 5*TB)")
    if n_subtiles <= 0 or f.shape != (n_subtiles * sub, 10):
        raise ValueError(f"f: shape {tuple(f.shape)}, expected ({n_subtiles * sub}, 10) "
                         f"for {n_subtiles} subtiles (one fewer than offsets)")
    tb = width // 5
    if origins.shape != (n_subtiles * sub, 3) or dirs.shape != origins.shape:
        raise ValueError(f"origins/dirs: shapes {tuple(origins.shape)}, {tuple(dirs.shape)}, "
                         f"expected ({n_subtiles * sub}, 3): one ray a row of f")
    if tri_data.shape != (nb, 16, tb) or radius.shape != (nb,):
        raise ValueError(f"tri_data/radius: shapes {tuple(tri_data.shape)}, "
                         f"{tuple(radius.shape)}, expected ({nb}, 16, {tb}) and ({nb},)")
    vec = int(tb % 4 == 0 and trif.data_ptr() % 16 == 0)
    best = torch.empty(n_subtiles * sub, dtype=torch.int64, device=device)
    t = torch.empty(n_subtiles * sub, dtype=torch.float32, device=device)
    slot = torch.empty(n_subtiles * sub, dtype=torch.int32, device=device)
    _launch("raycast_pairs", device,
            f.data_ptr(), origins.data_ptr(), dirs.data_ptr(), trif.data_ptr(),
            tri_data.data_ptr(), radius.data_ptr(), offsets.data_ptr(), blocks.data_ptr(),
            best.data_ptr(), t.data_ptr(), slot.data_ptr(),
            None if f64_count is None else f64_count.data_ptr(), n_subtiles,
            blocks.shape[0], tb, vec, float(w["t_init"]))
    return t, slot


def _culled_inputs(origins, dirs, tri_data, block_lo, block_hi, super_lo, super_hi,
                   super_factor: int, caller: str):
    """Check the culled kernel's inputs; returns (R, NB, NS, TB)."""
    device = origins.device
    if device.type != "cuda":
        raise ValueError(f"{caller}: origins is on {device}, not CUDA")
    for x, name, ndim in ((origins, "origins", 2), (dirs, "dirs", 2),
                          (tri_data, "tri_data", 3), (block_lo, "block_lo", 2),
                          (block_hi, "block_hi", 2), (super_lo, "super_lo", 2),
                          (super_hi, "super_hi", 2)):
        _check(x, name, torch.float32, ndim, device)
    n = origins.shape[0]
    nb, rows, tb = tri_data.shape
    ns = super_lo.shape[0]
    if origins.shape != (n, 3) or dirs.shape != (n, 3):
        raise ValueError(f"origins/dirs: shapes {tuple(origins.shape)}, "
                         f"{tuple(dirs.shape)}, expected (R, 3) each")
    if rows != 16:
        raise ValueError(f"tri_data: shape {tuple(tri_data.shape)}, expected (NB, 16, TB)")
    if block_lo.shape != (nb, 3) or block_hi.shape != (nb, 3):
        raise ValueError(f"block_lo/block_hi: expected ({nb}, 3)")
    if super_hi.shape != (ns, 3) or super_lo.shape != (ns, 3):
        raise ValueError(f"super_lo/super_hi: expected ({ns}, 3)")
    if super_factor <= 0 or ns * super_factor < nb:
        raise ValueError(f"{ns} supers of {super_factor} do not cover {nb} blocks")
    return n, nb, ns, tb


def raycast_culled_cuda(origins, dirs, tri_data, block_lo, block_hi,
                        super_lo, super_hi, super_factor: int, t_init: float):
    """Launch ``raycast_culled_kernel`` (csrc/raycast_culled.cu).

    origins, dirs (R, 3) float32; tri_data (NB, 16, TB) float32; block_lo,
    block_hi (NB, 3) and super_lo, super_hi (NS, 3) float32 with
    NS * super_factor >= NB; all on one CUDA device.  Returns (t (R,)
    float32, +inf on miss, slot (R,) int32, -1 on miss).
    """
    boxes = (tri_data, block_lo, block_hi, super_lo, super_hi)
    n, nb, ns, tb = _culled_inputs(origins, dirs, *boxes, super_factor, "raycast_culled_cuda")
    t = torch.empty(n, dtype=torch.float32, device=origins.device)
    slot = torch.empty(n, dtype=torch.int32, device=origins.device)
    if n == 0:
        return t, slot
    _launch("raycast_culled", origins.device, origins.data_ptr(), dirs.data_ptr(),
            *(x.data_ptr() for x in boxes), t.data_ptr(), slot.data_ptr(), n, nb, ns,
            int(super_factor), tb, float(t_init))
    return t, slot


# The counting instantiation's counts: warp visits of leaf blocks, tests of
# their active lanes, tests past the prescreen's determinant, u, v and t
# stages (the last are the divides), warp visits of supers.
CULLED_COUNTS = ("visits", "tests", "past_det", "past_u", "past_v", "divides",
                 "super_visits")


def raycast_culled_count_cuda(origins, dirs, tri_data, block_lo, block_hi,
                              super_lo, super_hi, super_factor: int, t_init: float):
    """Launch the counting instantiation of ``raycast_culled_kernel``: the
    same inputs and (t, slot) as ``raycast_culled_cuda``, plus a dict of
    ``CULLED_COUNTS``: the warp visits of leaf blocks, the ray-triangle
    tests of the active lanes in them, the tests that pass each stage of the
    prescreen (the last stage's divide) and the warp visits of super blocks.
    Counted under
    ``LAUNCHES["raycast_culled_count"]``; the main path never calls it."""
    boxes = (tri_data, block_lo, block_hi, super_lo, super_hi)
    n, nb, ns, tb = _culled_inputs(origins, dirs, *boxes, super_factor,
                                   "raycast_culled_count_cuda")
    device = origins.device
    t = torch.empty(n, dtype=torch.float32, device=device)
    slot = torch.empty(n, dtype=torch.int32, device=device)
    counts = torch.zeros(len(CULLED_COUNTS), dtype=torch.int64, device=device)
    if n:
        _launch("raycast_culled_count", device, origins.data_ptr(), dirs.data_ptr(),
                *(x.data_ptr() for x in boxes), t.data_ptr(), slot.data_ptr(),
                counts.data_ptr(), n, nb, ns, int(super_factor), tb, float(t_init))
    return t, slot, dict(zip(CULLED_COUNTS, counts.tolist()))


def _probe_common(f, trif, n_tiles: int, device: torch.device, bf16: bool = False):
    """Checks shared by the three probe kernels (csrc/raycast_probe.cu)."""
    _check(f, "f", torch.float32, 2, device)
    _check(trif, "trif", torch.bfloat16 if bf16 else torch.float32, 3, device)
    rows = 20 if bf16 else 10
    if trif.shape[1:] != (rows, 640):
        raise ValueError(f"trif: shape {tuple(trif.shape)}, expected (NB, {rows}, 640)")
    if trif.data_ptr() % 16:
        raise ValueError("trif: must be 16-byte aligned (cp.async copies)")
    if n_tiles <= 0 or f.shape != (n_tiles * 1024, 10):
        raise ValueError(f"f: shape {tuple(f.shape)}, expected (T * 1024, 10), T > 0")


def raycast_probe_call_cuda(f, ids, counts, ovf, trif, mode: str, t_init: float):
    """Launch ``probe_call_kernel`` in ``mode`` (csrc/raycast_probe.cu): each
    tile's walk cut into work items of at most ``ITEM_PANELS`` panels, taken
    from a queue by persistent CUDA blocks and merged by atomic minimum.

    f (T*1024, 10) float32; ids (V, T), counts (T,), ovf (T,) int32; trif
    (NB, 10, 640) float32, or (NB, 20, 640) bfloat16 hi/lo panels for mode
    "bf16"; all on one CUDA device.  The item offsets (``item_offsets``) are
    scanned on the device; nothing is read back.  Returns (t (T*1024,)
    float32, slot (T*1024,) int32).
    """
    return _probe_call(f, ids, counts, ovf, trif, mode, t_init)


def _probe_call(f, ids, counts, ovf, trif, mode: str, t_init: float, lib=None,
                item_panels: int | None = None):
    """``raycast_probe_call_cuda``; ``lib`` and ``item_panels`` run another
    build of the source whose items hold ``item_panels`` panels
    (``kernel_probe --against``)."""
    from ipcgen_tpu_torch.ops.raycast_probe import ITEM_PANELS, MODES, PACKED_MODES, item_offsets

    device = f.device
    if device.type != "cuda":
        raise ValueError(f"raycast_probe_call_cuda: f is on {device}, not CUDA")
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}; expected one of {MODES}")
    n_tiles = counts.shape[0]
    _probe_common(f, trif, n_tiles, device, bf16=mode == "bf16")
    for x, name in ((ids, "ids"), (counts, "counts"), (ovf, "ovf")):
        _check(x, name, torch.int32, 2 if name == "ids" else 1, device)
    if ids.shape[1] != n_tiles or ovf.shape != (n_tiles,) or ids.shape[0] == 0:
        raise ValueError(f"ids {tuple(ids.shape)}, ovf {tuple(ovf.shape)}: expected "
                         f"(V, {n_tiles}) and ({n_tiles},)")
    vmax, nb = ids.shape[0], trif.shape[0]
    offsets = item_offsets(counts, ovf, nb, vmax, item_panels or ITEM_PANELS)
    queue = torch.zeros(1, dtype=torch.int32, device=device)
    best = (torch.empty(n_tiles * 1024, dtype=torch.int64, device=device)
            if mode in PACKED_MODES else None)
    t = torch.empty(n_tiles * 1024, dtype=torch.float32, device=device)
    slot = torch.empty(n_tiles * 1024, dtype=torch.int32, device=device)
    _launch("raycast_probe_call", device, f.data_ptr(), ids.data_ptr(),
            counts.data_ptr(), ovf.data_ptr(), trif.data_ptr(), offsets.data_ptr(),
            queue.data_ptr(), None if best is None else best.data_ptr(), t.data_ptr(),
            slot.data_ptr(), n_tiles, vmax, nb, MODES.index(mode), float(t_init), lib=lib)
    return t, slot


def raycast_probe_grid_cuda(f, ids_flat, counts, trif, cap: int, t_init: float, *,
                            lib=None):
    """Launch ``probe_grid_kernel`` (csrc/raycast_probe.cu): one CUDA block
    per (tile, candidate) step, merged with 64-bit atomicMin.

    f (T*1024, 10) float32; ids_flat (T*cap,) and counts (T,) int32 with
    counts <= cap; trif (NB, 10, 640) float32.  Returns (t, slot).  ``lib``:
    another build of the source, uncounted (``kernel_probe --against``).
    """
    device = f.device
    if device.type != "cuda":
        raise ValueError(f"raycast_probe_grid_cuda: f is on {device}, not CUDA")
    n_tiles = counts.shape[0]
    _probe_common(f, trif, n_tiles, device)
    _check(ids_flat, "ids_flat", torch.int32, 1, device)
    _check(counts, "counts", torch.int32, 1, device)
    if cap <= 0 or ids_flat.shape != (n_tiles * cap,):
        raise ValueError(f"ids_flat: shape {tuple(ids_flat.shape)}, expected "
                         f"({n_tiles * cap},) for cap {cap}")
    best = torch.empty(n_tiles * 1024, dtype=torch.int64, device=device)
    t = torch.empty(n_tiles * 1024, dtype=torch.float32, device=device)
    slot = torch.empty(n_tiles * 1024, dtype=torch.int32, device=device)
    _launch("raycast_probe_grid", device, f.data_ptr(), ids_flat.data_ptr(),
            counts.data_ptr(), trif.data_ptr(), best.data_ptr(), t.data_ptr(),
            slot.data_ptr(), n_tiles, int(cap), float(t_init), lib=lib)
    return t, slot


def raycast_probe_flat_cuda(f, pair_tiles, pair_blocks, n_tiles: int, trif,
                            t_init: float, *, lib=None):
    """Launch ``probe_flat_kernel`` (csrc/raycast_probe.cu): one CUDA block
    per chunk of the flat (tile, block) pair list, merged with 64-bit
    atomicMin.

    f (T*1024, 10) float32; pair_tiles (P,) ascending and pair_blocks (P,)
    int32; trif (NB, 10, 640) float32.  Returns (t, slot).  ``lib`` as for
    the grid.
    """
    device = f.device
    if device.type != "cuda":
        raise ValueError(f"raycast_probe_flat_cuda: f is on {device}, not CUDA")
    _probe_common(f, trif, n_tiles, device)
    _check(pair_tiles, "pair_tiles", torch.int32, 1, device)
    _check(pair_blocks, "pair_blocks", torch.int32, 1, device)
    if pair_blocks.shape != pair_tiles.shape:
        raise ValueError("pair_tiles and pair_blocks must have one entry per pair")
    best = torch.empty(n_tiles * 1024, dtype=torch.int64, device=device)
    t = torch.empty(n_tiles * 1024, dtype=torch.float32, device=device)
    slot = torch.empty(n_tiles * 1024, dtype=torch.int32, device=device)
    _launch("raycast_probe_flat", device, f.data_ptr(), pair_tiles.data_ptr(),
            pair_blocks.data_ptr(), trif.data_ptr(), best.data_ptr(), t.data_ptr(),
            slot.data_ptr(), int(n_tiles), pair_tiles.shape[0], float(t_init), lib=lib)
    return t, slot


# The exact 1-NN's tiles (csrc/nn_exact.cu kQueryTile, kRefTile) and the
# blocks its grid aims for on each streaming multiprocessor: 4 resident over
# 4 waves.
NN_QUERY_TILE = 1024
NN_REF_TILE = 1024
NN_BLOCKS_PER_SM = 16
# The merge keys' start: (float bits of +inf << 32) | index 0.
_NN_NO_MATCH = 0x7F800000 << 32


def nn_exact_schedule(n: int, m: int, sms: int):
    """(chunk, splits) of the exact 1-NN's grid for n queries and m
    references on a card of ``sms`` multiprocessors: the reference range
    cut into ``splits`` chunks of ``chunk`` references (whole stages, no
    chunk empty), so that the query tiles times the splits make about
    ``NN_BLOCKS_PER_SM`` blocks a multiprocessor."""
    q_tiles = -(-n // NN_QUERY_TILE)
    r_tiles = -(-m // NN_REF_TILE)
    splits = min(r_tiles, 65535, max(1, -(-NN_BLOCKS_PER_SM * sms // q_tiles)))
    chunk = -(-r_tiles // splits) * NN_REF_TILE
    return chunk, -(-m // chunk)


def nn_exact_cuda(queries, refs):
    """Launch ``nn_exact_kernel`` (csrc/nn_exact.cu): the exact 1-NN of
    every query among ``refs``, ties to the smallest index.

    queries (N, 3) and refs (M, 3) float32 on one CUDA device, refs 16-byte
    aligned (cp.async copies), 0 < M < 2**31.  Allocates the (N,) merge keys
    and returns (N,) int64 indices into ``refs`` on the device, with no host
    read; N = 0 launches nothing.
    """
    device = queries.device
    if device.type != "cuda":
        raise ValueError(f"nn_exact_cuda: queries is on {device}, not CUDA")
    _check(queries, "queries", torch.float32, 2, device)
    _check(refs, "refs", torch.float32, 2, device)
    n, m = queries.shape[0], refs.shape[0]
    if queries.shape != (n, 3) or refs.shape != (m, 3):
        raise ValueError(f"queries/refs: shapes {tuple(queries.shape)}, "
                         f"{tuple(refs.shape)}, expected (N, 3) and (M, 3)")
    if m == 0:
        raise ValueError("nn_exact_cuda: empty reference set")
    if m >= 2**31 or n >= 2**31:
        raise ValueError(f"nn_exact_cuda: {n} queries, {m} references; at most 2**31 - 1")
    if refs.data_ptr() % 16:
        raise ValueError("refs: must be 16-byte aligned (cp.async copies)")
    keys = torch.full((n,), _NN_NO_MATCH, dtype=torch.int64, device=device)
    if n:
        chunk, splits = nn_exact_schedule(
            n, m, torch.cuda.get_device_properties(device).multi_processor_count)
        _launch("nn_exact", device, queries.data_ptr(), refs.data_ptr(), keys.data_ptr(),
                n, m, chunk, splits)
    return keys & 0xFFFFFFFF


def scene_codes_cuda(vertices, triangles, bits: int):
    """Launch ``scene_codes_launch`` (csrc/scene_asset.cu: ``centroid_kernel``
    then ``morton_kernel``): each triangle's centroid and its Morton code on
    a 2^bits grid over the centroids' bounds, as ``utils/native.py``
    ``morton_order`` codes them.

    vertices (V, 3) float32 and triangles (T, 3) int32, every index in
    [0, V), on one CUDA device; T > 0, 1 <= bits <= 10.  Returns (codes (T,)
    int32, keys (6,) int32: the bits of the centroids' per-axis minimum and
    maximum as ordered keys, which ``scene_pack_cuda`` reads), with no host
    read.
    """
    device = vertices.device
    if device.type != "cuda":
        raise ValueError(f"scene_codes_cuda: vertices is on {device}, not CUDA")
    _check(vertices, "vertices", torch.float32, 2, device)
    _check(triangles, "triangles", torch.int32, 2, device)
    n = triangles.shape[0]
    if vertices.shape[1:] != (3,) or triangles.shape[1:] != (3,) or n == 0:
        raise ValueError(f"vertices/triangles: shapes {tuple(vertices.shape)}, "
                         f"{tuple(triangles.shape)}, expected (V, 3) and (T, 3), T > 0")
    if not 1 <= bits <= 10:
        raise ValueError(f"bits must be in 1..10 (30-bit codes), got {bits}")
    centroids = torch.empty((n, 3), dtype=torch.float32, device=device)
    keys = torch.empty(6, dtype=torch.int32, device=device)
    codes = torch.empty(n, dtype=torch.int32, device=device)
    _launch("scene_codes", device, vertices.data_ptr(), triangles.data_ptr(),
            centroids.data_ptr(), keys.data_ptr(), codes.data_ptr(), n, int(bits),
            torch.cuda.get_device_properties(device).multi_processor_count)
    return codes, keys


def scene_pack_cuda(vertices, triangles, order, keys, n_blocks: int, block_size: int,
                    super_factor: int) -> dict:
    """Launch ``scene_pack_launch`` (csrc/scene_asset.cu: ``pack_kernel``, one
    CUDA block a leaf block, then ``supers_kernel``): the asset's eight
    arrays from the triangles in ``order``.

    vertices and triangles as for ``scene_codes_cuda``; order (T,) int64 a
    permutation of [0, T); keys (6,) int32 from ``scene_codes_cuda``;
    n_blocks * block_size >= T, 1 <= block_size <= 1024.  Returns the
    arrays by ``SceneAsset`` field name, with no host read.
    """
    device = vertices.device
    if device.type != "cuda":
        raise ValueError(f"scene_pack_cuda: vertices is on {device}, not CUDA")
    _check(vertices, "vertices", torch.float32, 2, device)
    _check(triangles, "triangles", torch.int32, 2, device)
    _check(order, "order", torch.int64, 1, device)
    _check(keys, "keys", torch.int32, 1, device)
    n = triangles.shape[0]
    if order.shape != (n,) or keys.shape != (6,) or n == 0:
        raise ValueError(f"order/keys: shapes {tuple(order.shape)}, {tuple(keys.shape)}, "
                         f"expected ({n},) and (6,), T > 0")
    if not 1 <= block_size <= 1024 or n_blocks * block_size < n or super_factor <= 0:
        raise ValueError(f"{n_blocks} blocks of {block_size} (at most 1024) for {n} "
                         f"triangles, super_factor {super_factor}")
    n_supers = -(-n_blocks // super_factor)
    slots = n_blocks * block_size
    f32 = dict(dtype=torch.float32, device=device)
    out = dict(
        tri_data=torch.empty((n_blocks, 16, block_size), **f32),
        block_lo=torch.empty((n_blocks, 3), **f32),
        block_hi=torch.empty((n_blocks, 3), **f32),
        super_lo=torch.empty((n_supers, 3), **f32),
        super_hi=torch.empty((n_supers, 3), **f32),
        tri_index=torch.empty(slots, dtype=torch.int32, device=device),
        tri_normal=torch.empty((slots, 3), **f32),
        tri_fin=torch.empty((slots, 4), **f32),
    )
    _launch("scene_pack", device, vertices.data_ptr(), triangles.data_ptr(), order.data_ptr(),
            keys.data_ptr(), *(out[k].data_ptr() for k in (
                "tri_data", "tri_index", "tri_normal", "tri_fin", "block_lo", "block_hi",
                "super_lo", "super_hi")),
            n, n_blocks, block_size, n_supers, super_factor)
    return out
