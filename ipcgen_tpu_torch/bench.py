"""Benchmark of the port on one card: rays per second of the fused scan
(port of ``bench.py``, function by function under its names).

    python -m ipcgen_tpu_torch.bench [--json-out PATH] [--pipeline-json PATH]

Workloads, each on the pair kernel (``"pairs"``) and the culled kernel
(``"culled"``) side by side, the box scan also on ``"auto"`` (the config's
default, ``ops.raycast_backends.port_backend``):

- box: the dense 32-line profile (128,000 rays a scan) over 20 waypoints of
  ``synthetic_room(200_000)`` (159,744 triangles), ``scan_waypoints(...,
  outputs="unordered")``;
- incoherent: 2.56 M rays from random origins in isotropic directions
  (``default_rng(0)``), ``raycast_asset`` unsorted, and again with the ray
  sort (the pair path's ``sort_rays=True``; the culled kernel has no sort of
  its own, so the bench sorts its rays with the same order in the timed call
  and scatters the results back);
- open scene: the room without its ceiling and its ``y > 4.95`` wall, 20 x
  128 k 32-line rays, so that rays really miss;
- recon mesh (the headline, on the kernel ``"auto"`` selects): a 500 k-point
  area-weighted sample of the room reconstructed by ``SurfaceReconstructor``
  at voxel 0.04 with ``mise_iter`` 1, cold then steady, and scanned as the
  box;
- BLK2GO x 80: the dual-axis profile with its angle noise, dropout and range
  noise over 80 waypoints (5.12 M rays).

Timing (``_timed``): one warm-up call, then ``reps`` calls each ended by
``torch.cuda.synchronize`` (per call) and ``reps`` queues of ``queue``
back-to-back calls ended by one (pipelined); the minimum, median and maximum
of each, the device memory the workload added at its peak
(``torch.cuda.max_memory_allocated`` over what was allocated when it began)
and the kernel launches it made.  The CPU baseline is a numpy two-level
culled raycaster over the same asset layout, run on 8,000 rays in a child
process (``--cpu-baseline``).

Prints one JSON line of at most 1,900 characters, with the card's name and
power limit (``nvidia-smi``) beside the numbers; ``--json-out`` also writes
the whole result there, and nothing is written without it.
``--pipeline-json`` names the JSON that ``python -m
ipcgen_tpu_torch.bench_pipeline --json-out`` wrote, whose steady numbers are
carried along.  ``run(device="cpu", sizes=...)`` runs the same workloads on
the CPU through the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

WAYPOINTS = 20
BENCH_TRIS = 200_000
LINE_BUDGET = 1900
KERNELS = ("pairs", "culled")
# The compact line's per-kernel array, in this order (peak_bytes: see _timed).
FIELDS = ("rays_per_s", "s_min", "s_median", "s_max", "per_call_s_min", "peak_bytes")

# Embree on a modern server CPU traverses about 10-50 M rays/s a core for
# scenes of this size; 50 M x 32 cores is the most generous stand-in for the
# reference engine without its per-frame BVH rebuild.  An assumed bound,
# not a measurement.
EMBREE_SOCKET_BOUND_RPS = 50e6 * 32


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Workload sizes; the defaults are the JAX bench's."""

    tris: int = BENCH_TRIS
    waypoints: int = WAYPOINTS
    horizontal_res: int = 4000  # dense 32-line: 128,000 rays a scan
    incoherent_rays: int = 2_560_000
    open_rays: int = 128_000  # a scan of the open scene
    open_waypoints: int = 20
    tls_points: int = 500_000
    recon_voxel: float = 0.04
    blk2go_waypoints: int = 80
    blk2go_point_rate: int = 640_000  # 64,000 rays a scan
    baseline_horizontal_res: int = 250  # the CPU baseline: 32 x 250 rays


def _mark(msg: str) -> None:
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def _seeded(device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(0)


def _build_workload(num_waypoints: int, horizontal_res: int = 4000, *,
                    tris: int = BENCH_TRIS, device="cpu"):
    """(asset on ``device``, dense 32-line intrinsics, (W, 4, 4) poses,
    triangle count) of the box scan."""
    from ipcgen_tpu_torch.models.lidar_intrinsics import Indoor8LineLidarIntrinsics
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.trajectory import Waypoint
    from ipcgen_tpu_torch.trajectory.waypoint import waypoints_to_pose_batch
    from ipcgen_tpu_torch.utils.synthetic import synthetic_room

    verts, tri = synthetic_room(tris)
    asset = build_scene_asset(verts, tri, device=device)
    intr = Indoor8LineLidarIntrinsics.create_dense_32line()
    if horizontal_res != 4000:
        intr.horizontal_res = horizontal_res  # reduced CPU-baseline workload
    wps = [
        Waypoint(1.0 + 4.0 * i / max(num_waypoints - 1, 1), 2.5, 1.0, 0.17 * i)
        for i in range(num_waypoints)
    ]
    poses = waypoints_to_pose_batch(wps)
    return asset, intr, poses, len(tri)


def _spread(xs) -> dict:
    return {"min": float(np.min(xs)), "median": float(np.median(xs)),
            "max": float(np.max(xs))}


def _timed(run, device, reps: int = 3, queue: int = 4):
    """Warm, then measure per-call latency and pipelined throughput.

    Per call: ``reps`` calls, each ended by a barrier on ``device``
    (``torch.cuda.synchronize``; it waits on the device and copies nothing
    to the host).  Pipelined: ``reps`` queues of ``queue`` back-to-back calls
    and one barrier a queue (one stream runs them in order), seconds per
    call.  Returns (stats, last output): the minimum of each (``seconds``,
    ``per_call_seconds``, as the JAX bench quotes), their minimum, median and
    maximum, the calls made (1 + reps + reps * queue), the kernel launches
    they made and ``peak_bytes``, the most device memory the calls held at
    once beyond what was allocated when they began (None off the card).
    """
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.utils.device import sync

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        sync(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
    before = dict(_kernels.LAUNCHES)
    calls = 1
    out = run()
    sync(device)  # warm
    per_call = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = run()
        sync(device)
        per_call.append(time.perf_counter() - t0)
        calls += 1
    piped = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(queue):
            out = run()
            calls += 1
        sync(device)
        piped.append((time.perf_counter() - t0) / queue)
    stats = {
        "seconds": float(np.min(piped)),
        "per_call_seconds": float(np.min(per_call)),
        "pipelined_s": _spread(piped),
        "per_call_s": _spread(per_call),
        "calls": calls,
        "launches": {k: v - before[k] for k, v in _kernels.LAUNCHES.items()
                     if v != before[k]},
        "peak_bytes": int(torch.cuda.max_memory_allocated(device) - base) if cuda else None,
    }
    return stats, out


def _platform(device) -> str:
    return "gpu" if torch.device(device).type == "cuda" else "cpu"


def _measure(backend: str, workload, reps: int = 3, queue: int = 4, *,
             apply_range_noise: bool = False) -> dict:
    """``scan_waypoints(..., outputs="unordered")`` of ``workload`` (asset,
    intrinsics, poses, triangles) on ``backend`` (a JAX name such as
    "auto", or a port name); every call draws from a generator seeded 0."""
    from ipcgen_tpu_torch.ops.raycast_backends import resolve_backend
    from ipcgen_tpu_torch.sim.scan import scan_waypoints

    asset, intr, poses, n_tris = workload
    port = resolve_backend(backend)

    def run():
        return scan_waypoints(asset, intr, poses, generator=_seeded(asset.device),
                              apply_range_noise=apply_range_noise,
                              outputs="unordered", backend=port)

    stats, batch = _timed(run, asset.device, reps=reps, queue=queue)
    n_rays = int(batch.t.numel())
    return {
        "rays": n_rays,
        "rays_per_sec": n_rays / stats["seconds"],
        "tris": n_tris,
        "waypoints": int(poses.shape[0]),
        "hit_fraction": float(batch.mask.float().mean()),
        "backend": backend,
        "kernel": port,
        "platform": _platform(asset.device),
        **stats,
    }


def _numpy_culled_raycast(origins, dirs, asset, t_max, tile=32):
    """Vectorized numpy CPU engine with the same 2-level culled traversal."""
    from ipcgen_tpu_torch.utils.device import to_host

    tri_data = to_host(asset.tri_data)  # (NB, 16, TB)
    blo = to_host(asset.block_lo)
    bhi = to_host(asset.block_hi)
    n = len(origins)
    best_t = np.full(n, np.inf, np.float32)
    for s in range(0, n, tile):
        o = origins[s : s + tile]
        d = dirs[s : s + tile]
        inv = 1.0 / d
        # slab test: (R, NB)
        t1 = (blo[None, :, :] - o[:, None, :]) * inv[:, None, :]
        t2 = (bhi[None, :, :] - o[:, None, :]) * inv[:, None, :]
        tmin = np.minimum(t1, t2).max(axis=2)
        tmax = np.maximum(t1, t2).min(axis=2)
        hit = (tmax >= np.maximum(tmin, 0)) & (tmin < t_max)
        cand = np.nonzero(hit.any(axis=0))[0]
        if len(cand) == 0:
            continue
        panels = tri_data[cand]  # (B, 16, TB)
        v0 = panels[:, 0:3].transpose(0, 2, 1).reshape(-1, 3)
        e1 = panels[:, 3:6].transpose(0, 2, 1).reshape(-1, 3)
        e2 = panels[:, 6:9].transpose(0, 2, 1).reshape(-1, 3)
        # Möller–Trumbore, (R, T') broadcast
        pvec = np.cross(d[:, None, :], e2[None, :, :])
        det = np.einsum("tk,rtk->rt", e1, pvec)
        inv_det = np.where(np.abs(det) > 1e-9, 1.0 / np.where(det == 0, 1, det), 0.0)
        tvec = o[:, None, :] - v0[None, :, :]
        u = np.einsum("rtk,rtk->rt", tvec, pvec) * inv_det
        qvec = np.cross(tvec, e1[None, :, :])
        v = np.einsum("rk,rtk->rt", d, qvec) * inv_det
        t = np.einsum("tk,rtk->rt", e2, qvec) * inv_det
        ok = (
            (np.abs(det) > 1e-9)
            & (u >= -1e-7)
            & (v >= -1e-7)
            & (u + v <= 1 + 1e-7)
            & (t > 1e-6)
        )
        t = np.where(ok, t, np.inf)
        best_t[s : s + tile] = np.minimum(best_t[s : s + tile], t.min(axis=1))
    return best_t


def _cpu_baseline(tris: int, horizontal_res: int) -> dict:
    """The numpy culled engine on one dense 32-line scan of ``horizontal_res``
    azimuth steps against the box workload's asset, built on the CPU."""
    from ipcgen_tpu_torch.models import beams

    asset, intr, poses, _ = _build_workload(1, horizontal_res=horizontal_res, tris=tris,
                                            device="cpu")
    dirs_sensor = beams.gen_vertical_degree_dirs(
        intr.vertical_degrees, intr.horizontal_res).numpy()
    pose = np.asarray(poses[0])
    dirs = dirs_sensor @ pose[:3, :3].T
    origins = np.tile(pose[:3, 3], (len(dirs), 1)).astype(np.float32)
    t0 = time.perf_counter()
    best_t = _numpy_culled_raycast(origins, dirs.astype(np.float32), asset,
                                   t_max=intr.max_range)
    dt = time.perf_counter() - t0
    return {
        "rays": len(dirs),
        "seconds": dt,
        "rays_per_sec": len(dirs) / dt,
        "hit_fraction": float(np.isfinite(best_t).mean()),
        "engine": "numpy 2-level culled raycaster",
    }


def _run_cpu_baseline(sizes: Sizes) -> Optional[dict]:
    """The CPU baseline in a child process (``--cpu-baseline``), so that it
    shares nothing with this process's device work; None if it printed no
    result."""
    proc = subprocess.run(
        [sys.executable, "-m", "ipcgen_tpu_torch.bench", "--cpu-baseline",
         str(sizes.tris), str(sizes.baseline_horizontal_res)],
        capture_output=True, text=True, timeout=1800,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    for line in proc.stdout.splitlines():
        if line.startswith("CPU_BASELINE "):
            return json.loads(line[len("CPU_BASELINE "):])
    _mark(f"cpu baseline printed no result (exit {proc.returncode}): "
          f"{proc.stderr[-2000:]}")
    return None


def _as_rays(origins, dirs, device):
    return (torch.as_tensor(np.asarray(origins, np.float32), device=device),
            torch.as_tensor(np.asarray(dirs, np.float32), device=device))


def _measure_raycast_direct(asset, origins, dirs, t_max, backend: str, reps=3,
                            queue: int = 4, *, sort_rays=False):
    """Direct kernel throughput of ``raycast_asset`` on an arbitrary ray set:
    (stats, last result).  ``sort_rays`` applies to the pair kernel; the
    culled kernel casts the rays in the order given."""
    from ipcgen_tpu_torch.ops.raycast import raycast_asset

    o, d = _as_rays(origins, dirs, asset.device)

    def run():
        return raycast_asset(o, d, asset, backend=backend, t_max=float(t_max),
                             sort_rays=sort_rays)

    stats, res = _timed(run, asset.device, reps=reps, queue=queue)
    return _direct_stats(stats, res, backend), res


def _measure_raycast_sorted(asset, origins, dirs, t_max, backend: str, reps=3,
                            queue: int = 4):
    """``raycast_asset`` with the coherence-restoring ray sort forced: the
    pair path's ``sort_rays=True``; for the culled kernel, which has no sort,
    the same order (``raycast_pairs.ray_sort_order``) taken in the timed call
    and the results scattered back.  (stats, last result)."""
    if backend == "pairs":
        return _measure_raycast_direct(asset, origins, dirs, t_max, backend, reps,
                                       queue, sort_rays=True)
    from ipcgen_tpu_torch.ops.raycast import RaycastResult, raycast_asset
    from ipcgen_tpu_torch.ops.raycast_pairs import _nanmax, _nanmin, ray_sort_order

    o, d = _as_rays(origins, dirs, asset.device)
    lo, hi = _nanmin(asset.block_lo, 0), _nanmax(asset.block_hi, 0)

    def run():
        order = ray_sort_order(o, d, lo, hi)
        res = raycast_asset(o[order], d[order], asset, backend=backend, t_max=float(t_max))
        return RaycastResult(*(torch.empty_like(x).index_put_((order,), x) for x in res))

    stats, res = _timed(run, asset.device, reps=reps, queue=queue)
    return _direct_stats(stats, res, backend), res


def _direct_stats(stats: dict, res, backend: str) -> dict:
    n = int(res.t.numel())
    return {"rays": n, "rays_per_sec": n / stats["seconds"],
            "hit_fraction": float(res.hit.float().mean()), "kernel": backend, **stats}


def _pair_lists(asset, origins, dirs, t_max, sort_rays: bool) -> dict:
    """The pair path's candidate lists for these rays, from one prepass
    before any timed call: pairs (subtile, block), the list's bytes, the
    walk's ray-triangle tests and the seconds of ``prepare_pairs``."""
    from ipcgen_tpu_torch.ops.raycast_pairs import prepare_pairs
    from ipcgen_tpu_torch.utils.device import sync

    o, d = _as_rays(origins, dirs, asset.device)
    t0 = time.perf_counter()
    p = prepare_pairs(o, d, asset.tri_data, asset.block_lo, asset.block_hi,
                      t_max=float(t_max), sort_rays=sort_rays)
    sync(asset.device)
    seconds = time.perf_counter() - t0
    pairs = int(p["blocks"].numel())
    return {"pairs": pairs,
            "list_bytes": pairs * p["blocks"].element_size()
            + p["offsets"].numel() * p["offsets"].element_size(),
            "walk_tests": pairs * p["sub"] * asset.tri_data.shape[2],
            "prepare_pairs_s": seconds}


def _agreement(a, b) -> dict:
    """Two kernels' results on the same rays: hit masks, the triangle where
    both hit, the hit points' error (p99 and maximum, mm)."""
    both = a.hit & b.hit
    err = (a.points[both] - b.points[both]).norm(dim=1).double()
    return {"hit_agree": float((a.hit == b.hit).float().mean()),
            "same_tri": float((a.tri_id[both] == b.tri_id[both]).float().mean())
            if bool(both.any()) else 1.0,
            "p99_mm": float(err.quantile(0.99) * 1e3) if err.numel() else 0.0,
            "max_mm": float(err.max() * 1e3) if err.numel() else 0.0}


def _incoherent_rays(n: int, seed: int = 0):
    """Random origins inside the room, isotropic random directions (the worst
    case for AABB culling: no angular coherence within a tile); float64."""
    rng = np.random.default_rng(seed)
    origins = rng.uniform([0.5, 0.5, 0.3], [5.5, 4.5, 2.2], (n, 3))
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins, dirs


def _open_scene_tris(verts, tris):
    """The room's triangles without the ceiling and the ``y > 4.95`` wall."""
    cz = verts[tris].mean(axis=1)  # triangle centroids
    keep = ~((cz[:, 2] > 2.45) | (cz[:, 1] > 4.95))
    return tris[keep]


def _open_scene_rays(r: int, waypoints: int = 20):
    """``waypoints`` x ``r`` 32-line wedge rays (``r // 32`` azimuths),
    origins along x at y 2.5, z 1.0; float32."""
    phis = np.tile(np.linspace(0, 2 * np.pi, r // 32, endpoint=False), 32)
    thetas = np.repeat(np.deg2rad(np.linspace(15, -20, 32)), r // 32)
    scan_dirs = np.stack(
        [np.cos(thetas) * np.cos(phis), np.cos(thetas) * np.sin(phis),
         np.sin(thetas)], axis=1,
    ).astype(np.float32)
    scan_dirs = np.tile(scan_dirs, (waypoints, 1))
    scan_origins = np.repeat(
        np.stack([np.linspace(1.0, 5.0, waypoints),
                  np.full(waypoints, 2.5), np.full(waypoints, 1.0)], axis=1), r, axis=0
    ).astype(np.float32)
    return scan_origins, scan_dirs


def _both_kernels(measure, *args, **kwargs):
    """``measure`` on each kernel: ({kernel: stats}, agreement of their
    results)."""
    stats, res = {}, {}
    for k in KERNELS:
        stats[k], res[k] = measure(*args, k, **kwargs)
    return stats, _agreement(res["pairs"], res["culled"])


def _extra_workloads(sizes: Sizes, device, reps: int = 3, queue: int = 4) -> dict:
    """The asset build, the incoherent rays unsorted and sorted, and the open
    scene, each on both kernels with the pair lists' sizes and the two
    kernels' agreement."""
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.utils.device import sync
    from ipcgen_tpu_torch.utils.synthetic import synthetic_room

    verts, tris = synthetic_room(sizes.tris)
    t0 = time.perf_counter()
    asset = build_scene_asset(verts, tris, device=device)
    sync(device)
    asset_build_s = time.perf_counter() - t0
    t_max = 20.0
    out = {"asset_build_seconds": asset_build_s}

    origins, dirs = _incoherent_rays(sizes.incoherent_rays)
    for name, sort in (("incoherent_random_rays", False),
                       ("incoherent_random_rays_sorted", True)):
        lists = _pair_lists(asset, origins, dirs, t_max, sort)
        _mark(f"extras: {name}: pair lists {lists}")
        measure = _measure_raycast_sorted if sort else _measure_raycast_direct
        stats, agree = _both_kernels(measure, asset, origins, dirs, t_max, reps=reps,
                                     queue=queue)
        out[name] = dict(stats, pair_lists=lists, agreement=agree)
        _mark(f"extras: {name} done: agreement {agree}")

    open_asset = build_scene_asset(verts, _open_scene_tris(verts, tris), device=device)
    origins, dirs = _open_scene_rays(sizes.open_rays, sizes.open_waypoints)
    lists = _pair_lists(open_asset, origins, dirs, t_max, False)
    stats, agree = _both_kernels(_measure_raycast_direct, open_asset, origins, dirs,
                                 t_max, reps=reps, queue=queue)
    out["open_scene_32line"] = dict(stats, pair_lists=lists, agreement=agree)
    _mark(f"extras: open scene done: agreement {agree}")
    return out


def _sample_tls_cloud(verts, tris, n_points, seed=0):
    """Area-weighted surface sampling of a mesh -> (points, normals)."""
    rng = np.random.default_rng(seed)
    v = verts[tris]  # (T, 3, 3)
    e1 = v[:, 1] - v[:, 0]
    e2 = v[:, 2] - v[:, 0]
    nrm = np.cross(e1, e2)
    area = 0.5 * np.linalg.norm(nrm, axis=1)
    p = area / area.sum()
    pick = rng.choice(len(tris), size=n_points, p=p)
    r1 = np.sqrt(rng.uniform(size=(n_points, 1))).astype(np.float32)
    r2 = rng.uniform(size=(n_points, 1)).astype(np.float32)
    pts = (
        (1 - r1) * v[pick, 0]
        + r1 * (1 - r2) * v[pick, 1]
        + r1 * r2 * v[pick, 2]
    ).astype(np.float32)
    normals = nrm[pick]
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True), 1e-9)
    return pts, normals.astype(np.float32)


def _blk2go_workload(box_asset, n_tris: int, sizes: Sizes):
    """The BLK2GO dual-axis profile over ``blk2go_waypoints`` waypoints, two
    rows of 40, on the box asset."""
    from ipcgen_tpu_torch.models.lidar_intrinsics import DualAxisLidarIntrinsics
    from ipcgen_tpu_torch.trajectory import Waypoint
    from ipcgen_tpu_torch.trajectory.waypoint import waypoints_to_pose_batch

    blk = DualAxisLidarIntrinsics.create_blk2go_dual_axis()
    blk.point_rate = sizes.blk2go_point_rate
    wps = [
        Waypoint(1.0 + 4.0 * (i % 40) / 39.0, 1.5 + 2.0 * (i // 40), 1.0, 0.157 * i)
        for i in range(sizes.blk2go_waypoints)
    ]
    return box_asset, blk, waypoints_to_pose_batch(wps), n_tris


def _production_workloads(box, sizes: Sizes, device, reps: int = 3,
                          queue: int = 4) -> dict:
    """The reconstructed mesh's dense 32-line scan (recon cold and steady)
    and the BLK2GO x 80 production profile, each on both kernels.  ``box``
    is the box workload of ``_build_workload``."""
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.recon.reconstructor import SurfaceReconstructor
    from ipcgen_tpu_torch.utils.synthetic import synthetic_room

    out = {}
    verts, tris = synthetic_room(sizes.tris)
    pts, normals = _sample_tls_cloud(verts, tris, n_points=sizes.tls_points)
    _mark("production: reconstructing...")
    recon = SurfaceReconstructor(voxel_size=sizes.recon_voxel, mise_iter=1, device=device)
    t_cold = time.perf_counter()
    mesh, rstats = recon.reconstruct(pts, normals)
    recon_cold_s = time.perf_counter() - t_cold
    # The port compiles nothing, so the steady run should cost what the cold
    # one did (the release gate's two passes agreed within 0.2 %).
    t_steady = time.perf_counter()
    mesh, rstats = recon.reconstruct(pts, normals)
    recon_steady_s = time.perf_counter() - t_steady
    faces = int(rstats["output_faces"])
    _mark(f"production: recon done ({faces} faces, cold {recon_cold_s:.2f} s / "
          f"steady {recon_steady_s:.2f} s), scanning...")
    recon_asset = build_scene_asset(np.asarray(mesh.vertices, np.float32),
                                    np.asarray(mesh.triangles, np.int32), device=device)
    workload = (recon_asset, box[1], box[2], faces)
    out["reconstructed_mesh_32line"] = {
        **{k: _measure(k, workload, reps, queue) for k in KERNELS},
        "mesh_faces": faces,
        "recon_seconds_cold": recon_cold_s,
        "recon_seconds_steady": recon_steady_s,
        "recon_spans_steady": rstats.get("spans", {}),
    }
    _mark("production: blk2go...")
    blk = _blk2go_workload(box[0], box[3], sizes)
    out["blk2go_dual_axis_80wp"] = {
        **{k: _measure(k, blk, reps, queue, apply_range_noise=True) for k in KERNELS},
        "noise": "angle + dropout + range (production profile)",
    }
    return out


def _pipeline_summary(path) -> Optional[dict]:
    """Compact numbers of the port's own ``bench_pipeline --json-out`` file
    (None without one): the six longest sim-stage spans and every
    ``label_bg_*`` span of the label prefetch (seconds; the profile's row
    counts, ``*_rows``, are left out)."""
    if path is None:
        return None
    with open(path) as f:
        p = json.load(f)
    spans = {k: v for k, v in p.get("sim_subspans_steady", {}).items()
             if isinstance(v, float) and not k.endswith("_rows")}
    top = dict(sorted(spans.items(), key=lambda kv: -kv[1])[:6])
    top.update({k: v for k, v in spans.items() if k.startswith("label_bg_")})
    return {
        "rooms_per_hour_steady": p.get("rooms_per_hour_steady"),
        "steady_room_seconds": p.get("steady_room_seconds"),
        "stage_seconds_steady": p.get("stage_seconds_steady"),
        "sim_subspans_top": top,
        "protocol": p.get("protocol"),
        "measured_at": p.get("timestamp"),
        "card": p.get("card"),
        "source": str(path),
    }


def _sig(x, digits: int = 4):
    """``x`` to ``digits`` significant digits (an int when that is exact)."""
    if x is None or x == 0:
        return x
    r = float(f"{x:.{digits - 1}e}")
    return int(r) if r.is_integer() else r


def _fields(m: dict) -> list:
    return [_sig(m["rays_per_sec"]), _sig(m["pipelined_s"]["min"]),
            _sig(m["pipelined_s"]["median"]), _sig(m["pipelined_s"]["max"]),
            _sig(m["per_call_s"]["min"]), m["peak_bytes"]]


def _workload_table(out: dict) -> dict:
    """{workload: {kernel: stats}} of every workload, from the full result."""
    d = out["details"]
    ex, prod = d["workloads"], d["production_workloads"]
    return {"box": d["box"], "incoherent": ex["incoherent_random_rays"],
            "incoherent_sorted": ex["incoherent_random_rays_sorted"],
            "open_scene": ex["open_scene_32line"],
            "recon_mesh": prod["reconstructed_mesh_32line"],
            "blk2go_80wp": prod["blk2go_dual_axis_80wp"]}


def _compact_line(out: dict) -> str:
    """The one JSON line: the headline, each workload's pair and culled
    figures (``FIELDS``), the recon's seconds, the CPU baseline, the card;
    at most ``LINE_BUDGET`` characters (else the headline alone)."""
    d = out["details"]
    rm = d["production_workloads"]["reconstructed_mesh_32line"]
    pipe = d["pipeline"]
    compact = {
        "metric": out["metric"],
        "value": _sig(out["value"], 6),
        "unit": "rays/s",
        "vs_baseline": _sig(out["vs_baseline"]),
        "card": out["card"],
        "details": {
            "platform": d["platform"],
            "auto": d["auto"],
            "recon_mesh_faces": rm["mesh_faces"],
            "recon_seconds_cold": _sig(rm["recon_seconds_cold"]),
            "recon_seconds_steady": _sig(rm["recon_seconds_steady"]),
            "box_160k_rays_per_sec": _sig(d["box_mesh_rays_per_sec"]),
            "blk2go_full_noise_rays_per_sec": _sig(
                d["production_workloads"]["blk2go_dual_axis_80wp"][d["auto"]]
                ["rays_per_sec"]),
            "baseline_rays_per_sec": _sig(d["baseline_rays_per_sec"]),
            "fields": list(FIELDS),
            "workloads": {w: {k: _fields(m[k]) for k in KERNELS}
                          for w, m in _workload_table(out).items()},
            "pipeline": None if pipe is None else {
                k: pipe.get(k) for k in ("rooms_per_hour_steady", "steady_room_seconds",
                                         "stage_seconds_steady", "measured_at", "source")},
            "note": "full details: --json-out",
        },
    }
    line = json.dumps(compact)
    if len(line) > LINE_BUDGET:  # hard tail budget: drop to the headline alone
        compact["details"] = {"note": "see --json-out"}
        line = json.dumps(compact)
    return line


def run(device=None, *, sizes: Sizes = Sizes(), reps: int = 3, queue: int = 4,
        pipeline_json=None, json_out=None):
    """Every workload on ``device`` (None: the card); returns (the whole
    result, the compact line).  Writes ``json_out`` when given, and no
    other file."""
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast_backends import port_backend
    from ipcgen_tpu_torch.utils.device import card_line, device_or_card

    device = device_or_card(device)
    cuda = device.type == "cuda"
    card = card_line() if cuda else "cpu"
    if cuda:
        _kernels.build()
    auto = port_backend("auto")
    pipeline = _pipeline_summary(pipeline_json)
    _mark(f"box 32-line scan on {card}...")
    box = _build_workload(sizes.waypoints, sizes.horizontal_res, tris=sizes.tris,
                          device=device)
    result = {k: _measure(k, box, reps, queue) for k in ("auto", *KERNELS)}
    _mark(f"box done: auto ({auto}) {result['auto']['rays_per_sec'] / 1e6:.2f} M rays/s")
    extras = _extra_workloads(sizes, device, reps, queue)
    production = _production_workloads(box, sizes, device, reps, queue)
    _mark("cpu baseline...")
    baseline = _run_cpu_baseline(sizes)
    baseline_rps = baseline["rays_per_sec"] if baseline else None

    headline = production["reconstructed_mesh_32line"][auto]["rays_per_sec"]
    box_auto = result["auto"]
    out = {
        "metric": "rays_per_sec_per_chip_32line_scan_recon_mesh",
        "value": headline,
        "unit": "rays/s",
        "vs_baseline": headline / baseline_rps if baseline_rps else None,
        "card": card,
        "details": {
            "workload": (f"{box_auto['waypoints']} waypoints x "
                         f"{box_auto['rays'] // box_auto['waypoints']}-ray 32-line scan, "
                         f"{box_auto['tris']} triangles"),
            "sizes": dataclasses.asdict(sizes),
            "reps": reps,
            "queue": queue,
            "auto": auto,
            "room_scan_seconds": box_auto["seconds"],
            "box_mesh_rays_per_sec": box_auto["rays_per_sec"],
            "box": result,
            "platform": _platform(device),
            "hit_fraction": box_auto["hit_fraction"],
            "production_workloads": production,
            "baseline": "numpy 2-level culled raycaster on host CPU (measured)",
            "baseline_detail": baseline,
            "baseline_rays_per_sec": baseline_rps,
            "embree_socket_bound_rays_per_sec": EMBREE_SOCKET_BOUND_RPS,
            "embree_socket_bound_note": "assumed (50 M rays/s a core x 32 cores), "
                                        "not measured",
            "vs_embree_socket_bound": box_auto["rays_per_sec"] / EMBREE_SOCKET_BOUND_RPS,
            "workloads": extras,
            "pipeline": pipeline,
        },
    }
    line = _compact_line(out)
    if json_out is not None:
        os.makedirs(os.path.dirname(os.path.abspath(json_out)), exist_ok=True)
        with open(json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json-out", default=None,
                    help="also write the whole result to this path")
    ap.add_argument("--pipeline-json", default=None,
                    help="the JSON of `python -m ipcgen_tpu_torch.bench_pipeline "
                         "--json-out`, carried along")
    # The child process of the CPU baseline: the box workload's triangles and
    # azimuth steps.
    ap.add_argument("--cpu-baseline", nargs=2, type=int, default=None,
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_baseline is not None:
        print("CPU_BASELINE " + json.dumps(_cpu_baseline(*args.cpu_baseline)))
        return 0

    from ipcgen_tpu_torch.utils.device_probe import wait_for_device

    if wait_for_device(max_wait_s=120.0, poll_s=15.0) is None:
        print(json.dumps({"metric": "rays_per_sec_per_chip_32line_scan_recon_mesh",
                          "value": None, "unit": "rays/s", "vs_baseline": None,
                          "details": {"error": "no card answered the device probe"}}))
        return 2
    _, line = run(pipeline_json=args.pipeline_json, json_out=args.json_out)
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
