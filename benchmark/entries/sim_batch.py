"""Entry ``sim_batch``: the sim stage's batch entry point
``ipcgen_tpu_torch.sim.simulator.main`` over reconstructed rooms.

Set-up writes the traffic's pool of rooms (mesh and TLS scan each) and
passes one warm room through ``main``.  Each call of the window is one
``main`` over a fresh reconstruction directory of ``rooms_per_call``
rooms, under names never used before (links to the pool's files), with a
fresh output directory: nothing is skipped, nothing is served from a
cache, and each call drains its own export, as a user's call over an area
does.  The outputs stay on disk until the check.
"""

from __future__ import annotations

import gc
import os
import shutil
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark import planner, reference, rooms, simcheck

AREA = "Area_1"


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, workdir: Path, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.sim = config["simulation"]
        self.workdir = Path(workdir)
        self.device = device
        self.data_root = self.workdir / "data"
        self.records: List[Dict] = []
        self.failed: List = []
        self.attempted = 0
        self._next = 0

    # -- traffic ------------------------------------------------------
    def setup(self) -> None:
        t = self.traffic
        self.pool = rooms.make_pool(
            self.workdir / "pool", self.seed, t["pool_rooms"], t["tls_points"],
            t["noise_std"], t["outlier_frac"], t["mesh_voxel_m"])
        # The warm room's outputs are not judged: a program that fails it
        # fails the window's rooms too.
        self._batch("warm", 1)
        shutil.rmtree(self.workdir / "warm")

    def _batch(self, tag: str, n: int):
        from ipcgen_tpu_torch.sim.simulator import main

        recon, out = self.workdir / tag / "recon", self.workdir / tag / "out"
        names = {}
        for _ in range(n):
            i = self._next
            self._next += 1
            pool_room = self.pool[i % len(self.pool)]
            name = f"office_{i}"
            scene = recon / f"{AREA}_{name}"
            scene.mkdir(parents=True)
            os.symlink(pool_room.mesh_path, scene / "mesh_dense.ply")
            rooms.link_room(self.data_root, AREA, name, pool_room)
            names[f"{AREA}_{name}"] = pool_room.k
        s = self.sim
        res = main(
            str(recon), num_waypoints=s["num_waypoints"], output_base_dir=str(out),
            use_gpu=True, robot_height=s["robot_height"],
            use_dense_lidar=s["use_dense_lidar"], use_blk2go=s["use_blk2go"],
            use_auto_trajectory=s["use_auto_trajectory"],
            s3dis_data_root=str(self.data_root), async_export=s["async_export"],
            save_visualizations=s["save_visualizations"],
            lidar_horizontal_res=s.get("lidar_horizontal_res"), device=self.device)
        recs = []
        for scene_name, sc in res["successful"]:
            recs.append({
                "scene": scene_name, "pool": names[scene_name],
                "ply": out / scene_name / "combined_pointcloud_with_label.ply",
                "poses": np.asarray(sc.scan_poses, np.float32),
                "counts": [len(f.points) for f in sc.frames],
                "profile": {k: float(v) for k, v in sc.profile.items()},
            })
        return recs, list(res["failed"])

    def call(self, k: int) -> None:
        n = self.traffic["rooms_per_call"]
        recs, failed = self._batch(f"b{k}", n)
        self.attempted += n
        self.records += recs
        self.failed += failed

    def done(self) -> int:
        return len(self.records)

    def trace_record(self) -> Dict:
        lidar = self.config["lidar"]
        rays = int(lidar["rays_per_scan"]) * int(lidar["frames_per_room"])
        tris = [self.pool[r["pool"]].triangles for r in self.records]
        return {"rooms": [r["profile"] for r in self.records],
                "scan": {"rays": rays, "triangles": float(np.mean(tris)) if tris else 0.0}}

    def release(self) -> None:
        gc.collect()

    # -- correctness --------------------------------------------------
    def check(self, control: bool = False) -> Dict[str, Dict]:
        lim = self.config["limits"]
        lidar = self.config["lidar"]
        pattern = reference.RayPattern(lidar["pattern"])
        ref, per_room, missing, cached = {}, [], len(self.failed), 0
        for i, rec in enumerate(self.records):
            if not rec["ply"].is_file():
                missing += 1
                continue
            prof = rec["profile"]
            if not (prof.get("load_scene", 0) > 0 and "label_bg_ann_parse" in prof):
                cached += 1
            if rec["pool"] not in ref:
                ref[rec["pool"]] = self._reference(self.pool[rec["pool"]], control)
            r = ref[rec["pool"]]
            rng = np.random.default_rng([int(self.seed) % (1 << 64), 7919, i])
            per_room.append(simcheck.room_numbers(
                rec["ply"], r["control_poses"] if control else rec["poses"], rec["counts"],
                r["poses"], r["tris"], r["labels"], pattern, lidar["rays_per_scan"],
                lidar["dropout_probability"], rng, self.traffic["hit_samples_per_room"],
                self.traffic["label_samples_per_room"], lim["hit_tol_m"], lim["label_tol_m"],
                self.device, control))
        nums = simcheck.combine(per_room)
        exact = ("layout_bad", "waypoints_off")
        return {
            "rooms_missing": {"value": float(missing), "limit": 0.0},
            "rooms_cached": {"value": float(cached), "limit": 0.0},
            **{k: {"value": nums[k], "limit": 0.0} for k in exact},
            **{k: {"value": nums[k], "limit": float(lim[k])}
               for k in ("frame_count_z", "ray_gap_mrad", "twin_share", "hit_off_share",
                         "label_off_share")},
        }

    def _reference(self, pool_room, control: bool) -> Dict:
        """What the reference works out for a pool room: the planner's
        poses over the room's mesh (and, for the control, over its
        vertices in bfloat16), its base triangles, its nearest labels."""
        verts, _ = reference.read_mesh(pool_room.mesh_path)
        n = self.sim["num_waypoints"]
        out = {"poses": planner.poses(planner.plan(verts, n)),
               "tris": pool_room.room.base_triangles(),
               "labels": reference.LabelReference(*pool_room.tls.labeled_points())}
        if control:
            try:
                out["control_poses"] = planner.poses(
                    planner.plan(reference.round_to(verts, torch.bfloat16), n))
            except ValueError:  # no trajectory: every pose is off
                out["control_poses"] = np.full_like(out["poses"], np.nan)
        return out
