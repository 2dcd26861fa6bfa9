"""One multi-device simulation step over ``torch.distributed`` (the port's
counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m ipcgen_tpu_torch.parallel.dryrun                  # NCCL, 1 rank on the card
    python -m ipcgen_tpu_torch.parallel.dryrun --world-size 2 --backend gloo \
        --waypoints 2 --min-rays 0                               # CPU ranks, small

Every rank runs ``dryrun``: the ray-parallel fused scan of at least 1 M
rays at its default size (8 lines x 2048 azimuth steps x 64 waypoints,
1,048,576 rays; the CLI checks the count) over a 10 k-triangle
synthetic room, the triangle-sharded and 2-D raycasts (with two ranks or
more), the hit-count reduction (``all_reduce``), two rooms' scans dispatched
before either is awaited, and the query-sharded 1-NN; each is held to its
one-device result.  ``run_ranks`` spawns a group of ranks that meet through
a ``FileStore`` and joins them with a timeout.
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import tempfile
import time
from datetime import timedelta
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist


def init_group(backend: str, store_file: str, world_size: int, rank: int,
               timeout_s: float = 300.0) -> None:
    """Join the default process group through a ``FileStore`` at
    ``store_file`` (no TCP port); with NCCL, rank r takes card r."""
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, store=dist.FileStore(store_file, world_size),
                            world_size=world_size, rank=rank,
                            timeout=timedelta(seconds=timeout_s))


def _rank_main(target: Callable, rank: int, world_size: int, backend: str,
               store_file: str, args: tuple, timeout_s: float) -> None:
    init_group(backend, store_file, world_size, rank, timeout_s)
    try:
        target(rank, world_size, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(target: Callable, world_size: int, backend: str = "gloo",
              store_file: Optional[str] = None, args: tuple = (),
              timeout_s: float = 300.0) -> None:
    """Run ``target(rank, world_size, *args)`` in ``world_size`` spawned
    processes joined in one group; raise if a rank fails or the group is not
    done within ``timeout_s`` (its processes are then killed).  ``target``
    must be importable by name (the ranks start from a fresh import)."""
    if store_file is None:
        store_file = os.path.join(tempfile.mkdtemp(prefix="dryrun_"), "store")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(target, r, world_size, backend, store_file, args, timeout_s))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.0))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    if hung:
        raise TimeoutError(f"ranks {hung} of {world_size} still running after {timeout_s} s")
    failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
    if failed:
        raise RuntimeError(f"ranks failed (rank: exit code): {failed}")


def _lawnmower_poses(n: int = 64) -> np.ndarray:
    """Waypoints of a sweep inside the synthetic room (6 x 5 x 2.5 m)."""
    from ipcgen_tpu_torch.trajectory import Waypoint
    from ipcgen_tpu_torch.trajectory.waypoint import waypoints_to_pose_batch

    return waypoints_to_pose_batch([
        Waypoint(0.8 + 4.4 * ((i % 16) / 15.0), 1.0 + 3.0 * (i // 16) / 3.0, 1.2, 0.2 * i)
        for i in range(n)
    ])


def dryrun(n_waypoints: int = 64) -> dict:
    """The multi-device step on this rank, its scans on the "auto" backend;
    every check raises on failure.  Returns the counts it checked (identical
    on every rank)."""
    from ipcgen_tpu_torch.models.lidar_intrinsics import Indoor8LineLidarIntrinsics
    from ipcgen_tpu_torch.ops.grid_nn import nearest_neighbor_indices_grid
    from ipcgen_tpu_torch.ops.raycast import raycast_asset
    from ipcgen_tpu_torch.ops.raycast_backends import resolve_backend
    from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset
    from ipcgen_tpu_torch.parallel.shard import (
        _axis,
        _mesh_device,
        make_device_mesh,
        scan_waypoints_sharded,
        sharded_grid_nn,
        sharded_raycast_2d,
        sharded_raycast_tris,
    )
    from ipcgen_tpu_torch.sim.scan import scan_waypoints
    from ipcgen_tpu_torch.utils.synthetic import synthetic_room

    mesh = make_device_mesh()
    device = _mesh_device(mesh)
    world = dist.get_world_size()
    v, t = synthetic_room(10_000)
    asset = build_scene_asset(v, t, device=device)
    port = resolve_backend("auto")

    # 1) The ray-parallel fused scan at scale: every ray of a closed room hits.
    intr = Indoor8LineLidarIntrinsics(vertical_res=32, horizontal_res=2048, max_range=20.0)
    poses = _lawnmower_poses(n_waypoints)
    gen = torch.Generator(device=device).manual_seed(0)
    batch = scan_waypoints_sharded(asset, intr, poses, mesh, generator=gen, backend=port)
    n_rays = batch.mask.numel()
    if not bool(batch.mask.all()):
        raise AssertionError("closed room: every ray must hit")
    want = scan_waypoints(asset, intr, poses, backend=port,
                          generator=torch.Generator(device=device).manual_seed(0))
    if not (torch.equal(batch.t, want.t) and torch.equal(batch.points, want.points)):
        raise AssertionError("the sharded scan differs from the one-device scan")

    # 2) Triangle-sharded and 2-D raycasts, on the culled kernel (bit-exact).
    rng = np.random.default_rng(0)
    origins = np.tile(np.array([2.0, 1.5, 1.0], np.float32), (256, 1))
    dirs = rng.normal(size=(256, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    one = raycast_asset(torch.from_numpy(origins), torch.from_numpy(dirs), asset,
                        backend="culled")
    for name, res in (
            ("tris", sharded_raycast_tris(origins, dirs, asset,
                                          make_device_mesh(axis_names=("tris",)),
                                          backend="culled")),
            ("2d", sharded_raycast_2d(origins, dirs, asset,
                                      make_device_mesh(axis_names=("rays", "tris")),
                                      backend="culled"))):
        if not (bool(res.hit.all()) and torch.equal(res.t, one.t)
                and torch.equal(res.tri_id, one.tri_id)):
            raise AssertionError(f"{name}-sharded raycast differs from one device")

    # 3) The hit-count reduction: each rank sums its shard of the mask.
    n_shards, index = _axis(mesh, "rays")
    flat = batch.mask.reshape(-1)
    per = -(-flat.numel() // n_shards)
    hits = flat[index * per:(index + 1) * per].sum().to(torch.int64).reshape(1)
    dist.all_reduce(hits)
    if int(hits) != n_rays:
        raise AssertionError(f"all_reduce of the hit counts: {int(hits)} != {n_rays}")

    # 4) Two rooms' scans dispatched on two devices before either is awaited.
    small = Indoor8LineLidarIntrinsics(vertical_res=4, horizontal_res=64,
                                       vertical_degrees=[10, 0, -10, -20], max_range=20.0)
    rooms = [asset.to(device), asset.to(device)]
    batches = [scan_waypoints(a, small, poses[:4], backend=port,
                              generator=torch.Generator(device=device).manual_seed(7))
               for a in rooms]
    if not torch.equal(batches[0].t, batches[1].t):
        raise AssertionError("the two rooms' scans differ")

    # 5) The query-sharded grid 1-NN against the one-device 1-NN.
    rng = np.random.default_rng(1)
    refs = rng.uniform(0, 4, (2000, 3)).astype(np.float32)
    queries = rng.uniform(0, 4, (512, 3)).astype(np.float32)
    idx = sharded_grid_nn(queries, refs, mesh, q_block=128)
    if not np.array_equal(idx, nearest_neighbor_indices_grid(queries, refs, device=device)):
        raise AssertionError("the sharded 1-NN differs from the one-device 1-NN")
    return dict(world_size=world, rays=n_rays, hits=int(hits), backend=port,
                device=str(device))


def _rank_dryrun(rank: int, world_size: int, n_waypoints: int, min_rays: int) -> None:
    res = dryrun(n_waypoints)
    if res["rays"] < min_rays:
        raise AssertionError(f"dryrun scanned only {res['rays']} rays")
    if rank == 0:
        print(f"[dryrun] OK on {world_size} ranks: {res}", flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--waypoints", type=int, default=64)
    ap.add_argument("--min-rays", type=int, default=1_000_000)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    run_ranks(_rank_dryrun, args.world_size, args.backend,
              args=(args.waypoints, args.min_rays),
              timeout_s=args.timeout)


if __name__ == "__main__":
    main()
