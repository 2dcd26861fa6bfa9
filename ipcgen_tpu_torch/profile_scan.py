"""Stage breakdown of the fused scan on one GPU, on the pair path and on
the culled path.

    python -m ipcgen_tpu_torch.profile_scan [--out FILE.json]

Builds the 638,976-triangle synthetic room (``synthetic_room(700_000)``, the
main room of ``chip_smoke.py``), plans the auto trajectory as the simulator
does (20 requested waypoints, seed 0) and, for the BLK2GO and dense 32-line
profiles and each backend (``profile_profile(..., backend=)``: "pairs" and
"culled"), times with host timers around ``torch.cuda.synchronize`` (mean
of ``REPS`` after one warm-up):

- ``scan_waypoints`` as the sim stage calls it (``outputs="unordered"``);
- its parts: the rays (``scan_rays``, in the backend's order) and, on the
  pair path, everything up to the walk (``prepare_pairs``) and, inside it,
  ``build_trif`` and the exact prepass (``exact_prepass``: count pass, CSR
  offsets with one host read, fill pass), the walk kernel
  (``raycast_pairs_cuda`` on the flat pair list); on the culled path the
  kernel (``raycast_culled_cuda``); then ``finalize_result``;
- pair path: from one prepass under ``torch.profiler``: the device time of
  its count and fill passes, and the rest of the prepass (the pair-list
  build: ``torch.cumsum`` of the list lengths, the host read that sizes the
  list, allocation), which is the prepass time less the two passes;
- pair path: the prepass counts: subtiles, pairs, mean and maximum list
  length, the tiles JAX's caps would overflow, and the ray-triangle tests
  the walk runs (25 fp32 FMAs, 50 flop, each);
- one scan under ``torch.profiler``: device time by kernel name.

Prints one JSON object (``{profile: {backend: ...}}``, and writes it to
``--out``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

FLOP_PER_TEST = 50  # 25 fp32 FMAs per (ray, triangle), csrc/raycast_pairs.cu
REPS = 3


def _timed(fn):
    """(mean ms over ``REPS`` after one warm-up, last result)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / REPS * 1e3, out


def profile_profile(asset, intr, poses, device, backend: str = "pairs") -> dict:
    """The breakdown of one profile's scan on ``backend`` ("pairs" or
    "culled")."""
    from ipcgen_tpu_torch.ops.raycast_culled import t_init_for
    from ipcgen_tpu_torch.sim.scan import scan_rays, scan_waypoints

    def gen():
        return torch.Generator(device=device).manual_seed(0)

    st = {"backend": backend}
    st["scan_waypoints_ms"], _ = _timed(
        lambda: scan_waypoints(asset, intr, poses, generator=gen(),
                               outputs="unordered", backend=backend))
    st["scan_rays_ms"], (o, d, _) = _timed(
        lambda: scan_rays(intr, poses, gen(), device, backend=backend))
    if backend == "pairs":
        _pair_parts(st, asset, intr, o, d)
    elif backend == "culled":
        from ipcgen_tpu_torch.ops import _kernels
        from ipcgen_tpu_torch.ops.raycast import finalize_result

        args = (o, d, asset.tri_data, asset.block_lo, asset.block_hi, asset.super_lo,
                asset.super_hi, asset.super_factor, t_init_for(float(intr.max_range)))
        st["culled_kernel_ms"], (t, slot) = _timed(
            lambda: _kernels.raycast_culled_cuda(*args))
        st["finalize_ms"], _ = _timed(lambda: finalize_result(o, d, t, slot, asset))
        st["rays"] = int(o.shape[0])
    else:
        raise ValueError(f"profile_profile: unknown backend {backend!r}")
    st["profiler_top_device_ms"] = _top_device_ms(
        lambda: scan_waypoints(asset, intr, poses, generator=gen(), outputs="unordered",
                               backend=backend))
    return st


def _top_device_ms(fn) -> list:
    """Device time by kernel name of one call of ``fn`` under
    ``torch.profiler``: [name, ms, calls] of the twelve longest."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    events.sort(key=lambda e: -e.self_device_time_total)
    return [[e.key[:70], round(e.self_device_time_total / 1e3, 3), e.count]
            for e in events[:12]]


def _pair_parts(st: dict, asset, intr, o, d) -> None:
    """The pair path's parts, passes and counts into ``st``."""
    from torch.profiler import ProfilerActivity, profile

    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops import raycast_pairs as rp
    from ipcgen_tpu_torch.ops.raycast import finalize_result

    comps = (asset.tri_data, asset.block_lo, asset.block_hi)
    max_range = float(intr.max_range)
    st["prepare_pairs_ms"], p = _timed(
        lambda: rp.prepare_pairs(o, d, *comps, t_max=max_range))
    tile = p["tile"]
    if o.shape[0] % tile:
        raise ValueError(f"{o.shape[0]} rays are not whole {tile}-ray tiles")
    center = (rp._nanmin(asset.block_lo, 0) + rp._nanmax(asset.block_hi, 0)) * 0.5
    st["build_trif_ms"], _ = _timed(lambda: rp.build_trif(asset.tri_data, center))

    def prepass():
        return rp.exact_prepass(o, d, asset.block_lo, asset.block_hi, t_max=p["t_init"],
                                group=p["group"], tile=tile, n_sub=tile // p["sub"])

    st["prepass_ms"], _ = _timed(prepass)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prepass()
        torch.cuda.synchronize()
    passes = {"count": 0.0, "fill": 0.0}
    for e in prof.key_averages():
        if "pairs_prepass" in e.key:
            passes["fill" if "pairs_prepass_fill" in e.key else "count"] += \
                e.self_device_time_total / 1e3
    st["prepass_count_pass_ms"] = passes["count"]
    st["prepass_fill_pass_ms"] = passes["fill"]
    st["pair_list_build_ms"] = st["prepass_ms"] - passes["count"] - passes["fill"]
    st["walk_ms"], (t, slot) = _timed(lambda: _kernels.raycast_pairs_cuda(p))
    st["finalize_ms"], _ = _timed(lambda: finalize_result(o, d, t, slot, asset))

    counts = (p["offsets"][1:] - p["offsets"][:-1]).long()
    tests = int(p["blocks"].numel()) * asset.tri_data.shape[2] * p["sub"]
    st.update(
        rays=int(o.shape[0]), tile=tile, group=p["group"], jax_gmax=p["gmax"],
        jax_vmax=p["vmax"], subtiles=int(counts.numel()),
        jax_overflow_frac=rp.overflow_frac(p), pairs=int(p["blocks"].numel()),
        mean_list_len=float(counts.float().mean()), max_list_len=int(counts.max()),
        walk_tests=tests, walk_tests_per_s=tests / (st["walk_ms"] * 1e-3),
    )
    st["walk_tflops"] = st["walk_tests_per_s"] * FLOP_PER_TEST / 1e12


def main_room(device):
    """The main room of ``chip_smoke.py`` and its auto trajectory as the
    simulator plans it (20 requested waypoints, seed 0): (triangle count,
    asset on ``device``, pose batch)."""
    from ipcgen_tpu_torch.containers.mesh import TriMesh
    from ipcgen_tpu_torch.containers.scene import RoomBounds
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.trajectory import AutoTrajectoryGenerator
    from ipcgen_tpu_torch.trajectory.waypoint import waypoints_to_pose_batch
    from ipcgen_tpu_torch.utils.synthetic import synthetic_room

    v, t = synthetic_room(700_000)
    mesh = TriMesh(vertices=v, triangles=t)
    asset = build_scene_asset(v, t, device=device)
    waypoints, _ = AutoTrajectoryGenerator(
        robot_radius=0.15, seed=0, occupancy_mode="vertices",
    ).generate_optimal_trajectory(
        mesh=mesh, room_bounds=RoomBounds.from_mesh(mesh).to_dict(), num_waypoints=20)
    return len(t), asset, waypoints_to_pose_batch(waypoints)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_scan needs a CUDA device")

    from ipcgen_tpu_torch.models.lidar_intrinsics import (
        DualAxisLidarIntrinsics,
        Indoor8LineLidarIntrinsics,
    )
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.utils.device import card_line

    device = torch.device("cuda", 0)
    card = card_line()
    _kernels.build()
    n_tris, asset, poses = main_room(device)
    out = {"card": card, "triangles": n_tris, "blocks": asset.num_blocks,
           "waypoints": int(poses.shape[0])}
    for name, intr in (("blk2go", DualAxisLidarIntrinsics.create_blk2go_dual_axis()),
                       ("dense32", Indoor8LineLidarIntrinsics.create_dense_32line())):
        out[name] = {backend: profile_profile(asset, intr, poses, device, backend)
                     for backend in ("pairs", "culled")}
    text = json.dumps(out, indent=1)
    print(text, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
