"""Entry ``pipeline``: the five-stage runner
``ipcgen_tpu_torch.run_pipeline.run`` (preprocess -> recon -> sim -> bbox
-> eval), one room a call.

Set-up writes the traffic's pool of TLS rooms, one real-scan stand-in for
the eval stage to match against (``lidarnet_0``: every sixth surface point
of pool room 0, in the LiDAR-Net layout the eval stage looks for under
the simulation results), and passes one warm room through ``run``.  Each
call of the window sets ``data.room_name`` to a fresh name that links to a
pool room, so no stage finds an output to skip; all calls share one output
root.  The sim stage's scene (frame origins and counts) is kept from its
return value by a wrapper around ``run_single_scene_simulation``; the
other outputs stay on disk until the check.
"""

from __future__ import annotations

import functools
import gc
import json
import pickle
import re
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark import planner, reference, rooms, simcheck

AREA = "Area_1"
STAGES = ("preprocess", "recon", "sim", "bbox", "eval")
# The classes the bbox stage boxes (upstream's S3DIS detection set).
DETECTION_CLASSES = ("window", "table", "chair", "sofa", "bookcase", "board", "stairs")


def _write_cloud_ply(path: Path, pts: np.ndarray) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    header = (f"ply\nformat binary_little_endian 1.0\nelement vertex {len(pts)}\n"
              "property float x\nproperty float y\nproperty float z\nend_header\n").encode()
    path.write_bytes(header + np.ascontiguousarray(pts, "<f4").tobytes())


def _report_numbers(text: str) -> Dict[str, float]:
    """The eval report's numbers, by label."""
    out = {}
    for key, label in (("s3dis_points", "S3DIS points"), ("lidar_net_points", "LiDAR-Net points"),
                       ("volume_diff_pct", "Volume difference")):
        m = re.search(rf"^\s*{re.escape(label)}: ([-0-9.,]+)", text, re.M)
        if m:
            out[key] = float(m.group(1).replace(",", ""))
    return out


class Cell:
    def __init__(self, config: Dict, traffic: Dict, seed: int, workdir: Path, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.workdir = Path(workdir)
        self.device = device
        self.records: List[Dict] = []
        self.attempted = 0
        self._scenes: Dict[str, object] = {}

    # -- traffic ------------------------------------------------------
    def setup(self) -> None:
        from ipcgen_tpu_torch import run_pipeline
        from ipcgen_tpu_torch.config import PipelineConfig
        from ipcgen_tpu_torch.sim import simulator

        t = self.traffic
        self.pool = rooms.make_pool(self.workdir / "pool", self.seed, t["pool_rooms"],
                                    t["tls_points"], t["noise_std"], t["outlier_frac"])
        tree = json.loads(json.dumps(self.config["pipeline"]))
        tree["data"].update(data_root=str(self.workdir / "data"),
                            output_root=str(self.workdir / "outputs"), area_name=AREA)
        tree["simulation"]["output_base_dir"] = str(self.workdir / "sim")
        self.cfg = PipelineConfig.from_dict(tree)
        surface, _, _ = self.pool[0].tls.labeled_points()
        self.candidate = surface[::6]
        _write_cloud_ply(self.workdir / "sim" / "lidarnet_0" / "lidarnet_0.ply", self.candidate)

        original = simulator.run_single_scene_simulation

        @functools.wraps(original)
        def keep_scene(*args, **kwargs):
            sc = original(*args, **kwargs)
            self._scenes[kwargs.get("scene_name")] = {
                "poses": np.asarray(sc.scan_poses, np.float32),
                "counts": [len(f.points) for f in sc.frames],
                "profile": {k: float(v) for k, v in sc.profile.items()},
            }
            return sc

        simulator.run_single_scene_simulation = keep_scene
        self._run = run_pipeline.run
        # The warm room's outputs are not judged: a program that fails it
        # fails the window's rooms too.
        self._room("warm", self.pool[0])

    def _room(self, name: str, pool_room) -> Dict:
        rooms.link_room(self.workdir / "data", AREA, name, pool_room)
        self.cfg.data.room_name = name
        report = self._run(self.cfg, STAGES, device=self.device)
        scene = f"{AREA}_{name}"
        return {"scene": scene, "pool": pool_room.k,
                "entry": report["rooms"].get(scene, {"error": "no report"}),
                "sim": self._scenes.pop(scene, None)}

    def call(self, k: int) -> None:
        self.attempted += 1
        self.records.append(self._room(f"office_{k}", self.pool[k % len(self.pool)]))

    def _ok(self, rec) -> bool:
        e = rec["entry"]
        return "error" not in e and all(str(e.get(s, "")).startswith("done") for s in STAGES)

    def done(self) -> int:
        return sum(self._ok(r) for r in self.records)

    def _paths(self, scene: str) -> Dict[str, Path]:
        out, sim = self.workdir / "outputs", self.workdir / "sim"
        return {
            "pickle": out / "preprocessed" / f"{scene}_preprocessed.pkl",
            "mesh": out / "reconstruction_results" / scene / "mesh_dense.ply",
            "recon_report": out / "reconstruction_results" / scene / "reconstruction_report.json",
            "ply": sim / scene / "combined_pointcloud_with_label.ply",
            "boxes": sim / scene / f"{scene}_detection_annotations.json",
            "eval": self.workdir / "evaluation_results" / scene / "single_scene_evaluation.txt",
        }

    def trace_record(self) -> Dict:
        rows = []
        for rec in self.records:
            p = self._paths(rec["scene"])
            row = {"preprocess_spans": None, "recon_s": None}
            if p["pickle"].is_file():
                with open(p["pickle"], "rb") as f:
                    row["preprocess_spans"] = dict(pickle.load(f).get("spans", {}))
            if p["recon_report"].is_file():
                rep = json.loads(p["recon_report"].read_text())
                row["recon_s"] = _recon_time(rep)
            rows.append(row)
        return {"pipeline": rows,
                "rooms": [r["sim"]["profile"] for r in self.records if r["sim"]]}

    def release(self) -> None:
        from ipcgen_tpu_torch.sim import simulator

        simulator.run_single_scene_simulation = getattr(
            simulator.run_single_scene_simulation, "__wrapped__",
            simulator.run_single_scene_simulation)
        gc.collect()

    # -- correctness --------------------------------------------------
    def check(self, control: bool = False) -> Dict[str, Dict]:
        lim = self.config["limits"]
        t = self.traffic
        pre = self.config["pipeline"]["preprocessing"]
        lidar = self.config["lidar"]
        ref = {}
        for p in self.pool:
            surf, sem, ins = p.tls.labeled_points()
            cloud = np.vstack([surf, p.tls.outliers_mm / 1000.0])
            keep = reference.stat_outlier_mask(cloud, pre["outlier_nb_neighbors"],
                                               pre["outlier_std_ratio"])
            ref[p.k] = {"cloud": cloud, "keep": keep,
                        "labels": reference.LabelReference(surf, sem, ins)}
        missing = sum(not self._ok(r) for r in self.records)
        n = {"far_kept": 0, "kept_diff": 0, "normal_checked": 0, "normal_off": 0,
             "box_count_bad": 0, "box_err_m": 0.0, "eval_bad": 0}
        pattern = reference.RayPattern(lidar["pattern"])
        n_wp = self.config["pipeline"]["simulation"]["num_waypoints"]
        sims = []
        for i, rec in enumerate(self.records):
            if not self._ok(rec):
                continue
            pr, paths = ref[rec["pool"]], self._paths(rec["scene"])
            rng = np.random.default_rng([int(self.seed) % (1 << 64), 104729, i])
            self._check_preprocess(paths, pr, pre, rng, control, n)
            verts, tris = reference.read_mesh(paths["mesh"])
            s = rec["sim"]
            # The sim stage plans over the recon's mesh: so does the reference.
            ref_poses = planner.poses(planner.plan(verts, n_wp))
            poses = (planner.poses(planner.plan(reference.round_to(verts, torch.bfloat16), n_wp))
                     if control else s["poses"])
            sims.append(simcheck.room_numbers(
                paths["ply"], poses, s["counts"], ref_poses, verts[tris], pr["labels"],
                pattern, lidar["rays_per_scan"], lidar["dropout_probability"], rng,
                t["hit_samples_per_room"], t["label_samples_per_room"], lim["hit_tol_m"],
                lim["label_tol_m"], self.device, control))
            self._check_boxes(paths, rec["pool"], control, n)
            self._check_eval(paths, n)
        sim = simcheck.combine(sims)
        L = lambda v, k: {"value": float(v), "limit": float(lim[k])}
        return {
            "rooms_missing": {"value": float(missing), "limit": 0.0},
            "far_outliers_kept": {"value": float(n["far_kept"]), "limit": 0.0},
            "kept_count_diff": {"value": float(n["kept_diff"]), "limit": 0.0},
            "normal_off_share": L(n["normal_off"] / max(n["normal_checked"], 1),
                                  "normal_off_share"),
            "layout_bad": {"value": sim["layout_bad"], "limit": 0.0},
            "waypoints_off": {"value": sim["waypoints_off"], "limit": 0.0},
            "frame_count_dev": L(sim["frame_count_dev"], "frame_count_dev"),
            "hit_off_share": L(sim["hit_off_share"], "hit_off_share"),
            "label_off_share": L(sim["label_off_share"], "label_off_share"),
            "box_count_bad": {"value": float(n["box_count_bad"]), "limit": 0.0},
            "box_err_m": L(n["box_err_m"], "box_err_m"),
            "eval_bad": {"value": float(n["eval_bad"]), "limit": 0.0},
        }

    def _check_preprocess(self, paths, pr, pre, rng, control, n) -> None:
        """Far outliers gone; the kept count against the statistical rule;
        normals of a sample against float64 PCA."""
        with open(paths["pickle"], "rb") as f:
            room = pickle.load(f)
        pts = np.asarray(room["points"], np.float64)
        normals = np.asarray(room["normals"], np.float64)
        size = np.asarray(rooms.ROOM_SIZE)
        n_kept = len(pts)
        if control:
            keep = reference.stat_outlier_mask(pr["cloud"], pre["outlier_nb_neighbors"],
                                               pre["outlier_std_ratio"], torch.bfloat16)
            pts, n_kept = pr["cloud"][keep], int(keep.sum())
        n["far_kept"] += int(np.sum(np.any((pts < -0.1) | (pts > size + 0.1), axis=1)))
        n["kept_diff"] += abs(n_kept - int(pr["keep"].sum()))
        pick = rng.choice(len(pts), size=min(self.traffic["normal_samples_per_room"], len(pts)),
                          replace=False)
        ref_n = reference.pca_normals(pr["cloud"], pts[pick], pre["normal_search_radius"],
                                      pre["normal_max_nn"], exclude=~pr["keep"])
        got = (reference.pca_normals(pr["cloud"], pts[pick], pre["normal_search_radius"],
                                     pre["normal_max_nn"], exclude=~pr["keep"],
                                     dtype=torch.bfloat16)
               if control else normals[pick])
        cos = np.abs(np.sum(ref_n * got, axis=1)) / np.maximum(
            np.linalg.norm(got, axis=1), 1e-300)
        n["normal_checked"] += len(pick)
        n["normal_off"] += int(np.sum(~(cos >= self.config["limits"]["normal_min_cos"])))

    def _check_boxes(self, paths, k, control, n) -> None:
        """Each box against the statistical rule and the axis-aligned box of
        its instance's annotation points, float64, with the stage's gates."""
        want = self._boxes(k, None)
        if control:
            got = [{"original_class_name": c, "bbox_3d": {"min_coords": lo, "max_coords": hi}}
                   for c, lo, hi in self._boxes(k, torch.bfloat16)]
        else:
            got = json.loads(paths["boxes"].read_text())["annotations"]
        if len(got) != len(want) or any(g["original_class_name"] != w[0]
                                        for g, w in zip(got, want)):
            n["box_count_bad"] += 1
            return
        for g, (_, lo, hi) in zip(got, want):
            err = max(np.max(np.abs(np.asarray(g["bbox_3d"]["min_coords"]) - lo)),
                      np.max(np.abs(np.asarray(g["bbox_3d"]["max_coords"]) - hi)))
            n["box_err_m"] = max(n["box_err_m"], float(err))

    def _boxes(self, k, dtype):
        """[(class, lo, hi)] of the room's detection-class instances, in file
        order, through the statistical rule (k = 20, ratio 2.0) and the
        stage's gates; with ``dtype`` computed in it (the control)."""
        gates = self.config["pipeline"]["bbox"]
        tls = self.pool[k].tls
        out = []
        for name in sorted(tls.instances):
            cls = name.rsplit("_", 1)[0]
            if cls not in DETECTION_CLASSES:
                continue
            pts = tls.instances[name][0] / 1000.0
            if dtype is not None:
                pts = reference.round_to(pts, dtype)
            keep = (reference.stat_outlier_mask(pts, 20, 2.0, dtype)
                    if len(pts) > 20 else np.ones(len(pts), bool))
            lo, hi = reference.aabb(pts[keep])
            size = np.sort(hi - lo)
            if (keep.sum() >= gates["min_points"] and np.prod(size) >= gates["min_volume"]
                    and size[0] > 0 and size[2] / size[0] <= gates["max_aspect_ratio"]):
                out.append((cls, lo, hi))
        return out

    def _check_eval(self, paths, n) -> None:
        """The report's point counts and volume difference, recomputed from
        the labeled PLY and the real-scan stand-in."""
        got = _report_numbers(paths["eval"].read_text())
        sim_pts, _, _ = reference.read_labeled_cloud(paths["ply"])
        cand = np.asarray(self.candidate, np.float32).astype(np.float64)
        vol = lambda p: float(np.prod(p.max(0) - p.min(0)))
        v1, v2 = vol(sim_pts), vol(cand)
        vdiff = abs(v1 - v2) / max(v1, v2) * 100.0  # the report prints two decimals
        if (got.get("s3dis_points") != len(sim_pts) or got.get("lidar_net_points") != len(cand)
                or abs(got.get("volume_diff_pct", -1.0) - vdiff) > 0.006):
            n["eval_bad"] += 1


def _recon_time(report: Dict):
    """``reconstruction_time`` of the dense variant in the recon report."""
    found = []

    def walk(x):
        if isinstance(x, dict):
            for k, v in x.items():
                if k == "reconstruction_time" and isinstance(v, (int, float)):
                    found.append(float(v))
                else:
                    walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)

    walk(report)
    return sum(found) if found else None
