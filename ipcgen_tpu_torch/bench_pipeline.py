"""End-to-end pipeline benchmark: S3DIS-scale rooms per hour on the card
(port of ``scripts/bench_pipeline.py``).

    python -m ipcgen_tpu_torch.bench_pipeline [--rooms 3] [--passes 1] [--json-out PATH]

Synthesizes TLS-style dense rooms (shell and furniture clouds with
per-instance annotations, about 0.6 M points), runs preprocess, recon, sim
(BLK2GO) and bbox per room on the card, and prints one JSON line of
per-stage seconds and rooms per hour, with the card's name and power limit
(``nvidia-smi``) beside them.  The first room pays one-off costs (the
kernels' build, first allocations); with ``--passes N`` the last pass is the
steady state.  ``--json-out`` also writes the JSON there, and nowhere else.
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np


def synth_room(root: Path, area: str, room: str, rng, n_shell=600_000,
               n_furniture=8):
    """An S3DIS-layout room under ``root/area/room``: a box shell of
    ``n_shell`` points and ``n_furniture`` box objects, each part an
    annotation file; returns the room's point count."""
    d = root / area / room
    ann = d / "Annotations"
    ann.mkdir(parents=True, exist_ok=True)
    w = rng.uniform(4.5, 8.0)
    h = rng.uniform(3.5, 6.0)
    z = 2.7

    def surf(n, axis, value, lo, hi):
        pts = rng.uniform(0, 1, (n, 3)) * (np.array(hi) - lo) + lo
        pts[:, axis] = value
        return pts

    lo = [0.0, 0.0, 0.0]
    hi = [w, h, z]
    floor = surf(int(n_shell * 0.25), 2, 0.0, lo, hi)
    ceil_ = surf(int(n_shell * 0.2), 2, z, lo, hi)
    walls = np.vstack([
        surf(int(n_shell * 0.14), 0, 0.0, lo, hi),
        surf(int(n_shell * 0.14), 0, w, lo, hi),
        surf(int(n_shell * 0.14), 1, 0.0, lo, hi),
        surf(int(n_shell * 0.13), 1, h, lo, hi),
    ])
    parts = {"floor_1": floor, "ceiling_1": ceil_, "wall_1": walls}
    classes = ["chair", "table", "sofa", "bookcase", "board"]
    counters = {c: 0 for c in classes}
    for _ in range(n_furniture):
        c = classes[int(rng.integers(0, len(classes)))]
        counters[c] += 1
        size = {
            "chair": [0.5, 0.5, 0.9], "table": [1.4, 0.8, 0.75],
            "sofa": [1.8, 0.9, 0.8], "bookcase": [0.9, 0.35, 1.9],
            "board": [1.6, 0.35, 1.1],
        }[c]
        pos = [rng.uniform(0.5, w - 0.5 - size[0]), rng.uniform(0.5, h - 0.5 - size[1]), 0]
        n_pts = int(4000 * np.prod(size) ** 0.5) + 500
        # Points on the box faces.
        u = rng.uniform(0, 1, (n_pts, 3)) * size + pos
        face = rng.integers(0, 6, n_pts)
        for ax in range(3):
            mlo = face == 2 * ax
            mhi = face == 2 * ax + 1
            u[mlo, ax] = pos[ax] if ax < 2 else 0
            u[mhi, ax] = pos[ax] + size[ax] if ax < 2 else size[ax]
        parts[f"{c}_{counters[c]}"] = u
    cloud, colors = [], []
    for name, pts in parts.items():
        cloud.append(pts)
        colors.append(np.tile(rng.integers(40, 220, 3), (len(pts), 1)))
        np.savetxt(ann / f"{name}.txt",
                   np.hstack([pts, np.tile(rng.integers(40, 220, 3), (len(pts), 1))]),
                   fmt="%.4f %.4f %.4f %d %d %d")
    data = np.hstack([np.vstack(cloud), np.vstack(colors)])
    np.savetxt(d / f"{room}.txt", data, fmt="%.4f %.4f %.4f %d %d %d")
    return len(data)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rooms", type=int, default=3)
    ap.add_argument("--shell-points", type=int, default=600_000)
    ap.add_argument("--workdir", default=None,
                    help="scratch directory (default: a new temporary one)")
    ap.add_argument("--waypoints", type=int, default=20)
    ap.add_argument("--passes", type=int, default=1,
                    help="run the same rooms N times in-process; the last pass is "
                    "the steady state")
    ap.add_argument("--json-out", default=None,
                    help="also write the result JSON to this path")
    args = ap.parse_args(argv)

    from ipcgen_tpu_torch.utils.device_probe import wait_for_device

    platform = wait_for_device(max_wait_s=120.0, poll_s=15.0, probe_timeout_s=120.0)
    if platform is None:
        print(json.dumps({"error": "no card answered the device probe"}))
        raise SystemExit(2)
    from ipcgen_tpu_torch.utils.device import card_line, sync

    card = card_line()
    print(f"device probe ok: {platform}, {card}", flush=True)

    work = Path(args.workdir or tempfile.mkdtemp(prefix="bench_pipeline_"))
    if args.workdir and work.exists():
        shutil.rmtree(work)
    data_root = work / "data"
    rng = np.random.default_rng(0)

    from ipcgen_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.data.data_root = str(data_root)
    cfg.data.output_root = str(work / "outputs")
    cfg.data.area_name = "Area_1"
    cfg.nksr.voxel_size = 0.04
    cfg.nksr.chunked = False
    cfg.simulation.num_waypoints = args.waypoints
    cfg.simulation.use_blk2go = True
    cfg.simulation.output_base_dir = str(work / "simulation_results")
    cfg.simulation.save_visualizations = False

    rooms = [f"office_{i+1}" for i in range(args.rooms)]
    print("synthesizing rooms...", flush=True)
    for room in rooms:
        n = synth_room(data_root, "Area_1", room, rng, n_shell=args.shell_points)
        print(f"  {room}: {n:,} points", flush=True)

    from ipcgen_tpu_torch.bbox.detection import S3DISBBoxVisualizer
    from ipcgen_tpu_torch.containers.sim_scene import prewarm_labels
    from ipcgen_tpu_torch.preprocess.loader import preprocess_room
    from ipcgen_tpu_torch.recon.cli import reconstruct_room
    from ipcgen_tpu_torch.sim.simulator import run_single_scene_simulation

    stage_times = {"preprocess": [], "recon": [], "sim": [], "bbox": []}
    sim_profiles, recon_spans_all, pre_spans_all, room_times = [], [], [], []

    def run_room(room, pass_tag):
        t_room = time.time()
        t0 = time.time()
        rd = preprocess_room(
            str(data_root), "Area_1", room, cfg.to_dict(),
            output_dir=str(work / "outputs" / f"preprocessed{pass_tag}"), seed=0,
        )
        stage_times["preprocess"].append(time.time() - t0)
        pre_spans_all.append(dict(rd.get("spans", {})))
        # The room is known now: start its label prefetch so that it hides
        # behind the recon stage.
        prewarm_labels(str(data_root), "Area_1", room)
        t0 = time.time()
        recon_dir = work / "outputs" / f"reconstruction_results{pass_tag}"
        rspans = {}
        reconstruct_room(rd["output_path"], cfg.to_dict(), str(recon_dir), span_sink=rspans)
        recon_spans_all.append(rspans)
        stage_times["recon"].append(time.time() - t0)
        t0 = time.time()
        scene_name = f"Area_1_{room}"
        out_base = f"{cfg.simulation.output_base_dir}{pass_tag}"
        sim_scene = run_single_scene_simulation(
            scene_path=str(recon_dir / scene_name / "mesh_dense.ply"),
            scene_name=scene_name, num_waypoints=args.waypoints,
            output_base_dir=out_base, use_blk2go=True, s3dis_data_root=str(data_root),
            area="Area_1", room=room, save_visualizations=False,
        )
        sync()
        stage_times["sim"].append(time.time() - t0)
        sim_profiles.append(dict(sim_scene.profile))
        t0 = time.time()
        S3DISBBoxVisualizer(results_root=out_base).visualize_room_bboxes(
            data_root / "Area_1" / room)
        stage_times["bbox"].append(time.time() - t0)
        room_times.append(time.time() - t_room)
        print(f"{room}{pass_tag} on {card}: {room_times[-1]:.1f}s "
              f"(pre {stage_times['preprocess'][-1]:.1f} / "
              f"recon {stage_times['recon'][-1]:.1f} / "
              f"sim {stage_times['sim'][-1]:.1f} / "
              f"bbox {stage_times['bbox'][-1]:.1f})", flush=True)

    for p in range(args.passes):
        for room in rooms:
            run_room(room, "" if p == 0 else f"_p{p}")

    # Steady: the last pass with several passes, else rooms 2+ of the one.
    n_steady = args.rooms if args.passes > 1 else max(len(room_times) - 1, 1)
    steady = room_times[-n_steady:]
    steady_stage = {k: v[-n_steady:] for k, v in stage_times.items()}
    steady_profiles = sim_profiles[-n_steady:]

    def mean_spans(spans):
        return {k: float(np.mean([p.get(k, 0.0) for p in spans[-n_steady:]]))
                for k in sorted({k for p in spans for k in p})}

    out = {
        "card": card,
        "protocol": (
            f"{args.rooms} synthetic ~{args.shell_points // 1000}k-pt rooms, "
            f"BLK2GO {args.waypoints}-waypoint auto trajectory, "
            f"{args.passes}-pass in-process (last pass = steady)"
        ),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "rooms": len(rooms),
        "passes": args.passes,
        "first_room_seconds": room_times[0],
        "steady_room_seconds": float(np.mean(steady)),
        "rooms_per_hour_steady": 3600.0 / float(np.mean(steady)),
        "best_room_seconds": float(np.min(steady)),
        "rooms_per_hour_best": 3600.0 / float(np.min(steady)),
        "stage_seconds_steady": {k: float(np.mean(v)) for k, v in steady_stage.items()},
        "stage_seconds_best": {k: float(np.min(v)) for k, v in steady_stage.items()},
        "sim_subspans_steady": mean_spans(steady_profiles),
        "recon_subspans_steady": mean_spans(recon_spans_all),
        "preprocess_subspans_steady": mean_spans(pre_spans_all),
    }
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json_out}", flush=True)
    if not args.workdir:
        shutil.rmtree(work, ignore_errors=True)
    return out


if __name__ == "__main__":
    main()
