"""Release gate: the five-stage pipeline on the concave L-shaped golden room,
on the card, with per-stage seconds and format parity (port of
``scripts/release_gate_lroom.py``).

    python -m ipcgen_tpu_torch.release_gate_lroom [--passes 2] [--json-out PATH]

The golden L-room (``tests/fixtures/golden_room_l``: a concave floor plan,
rotated oblique furniture) runs through the five stages, one
``run_pipeline.run`` call a stage (eval against a LiDAR-Net scene built from
the fixture's annotations), ``--passes`` times in-process: pass 1 cold,
the last pass steady.  The last pass is held to the golden test's format
contracts: the labeled PLY read back by a point-by-point reference reader
(kept here), more than 50,000 points, the detection JSON, the statistics
text, the evaluation report.  Prints one JSON line with cold and steady
per-stage seconds beside the card's name and power limit (the only numbers
it prints); exits non-zero on any parity failure.  ``run_gate(device=...)``
runs it in-process.
"""

from __future__ import annotations

import argparse
import json
import shutil
import struct
import tempfile
import time
from pathlib import Path

import numpy as np

FIXTURE = Path(__file__).resolve().parents[1] / "tests" / "fixtures" / "golden_room_l"
AREA, ROOM = "Area_2", "lounge_1"
SCENE = f"{AREA}_{ROOM}"


def reference_read_labeled_ply(path) -> dict:
    """The reference's byte walk of a labeled PLY: the header must name sem
    and ins properties; each 19-byte record is x, y, z (f32), r, g, b (u8),
    sem, ins (native u16); no byte may follow the last record."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("utf-8").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        property_lines = [ln for ln in header_lines if ln.startswith("property")]
        if not (any("sem" in ln for ln in property_lines)
                and any("ins" in ln for ln in property_lines)):
            raise AssertionError("reference reader requires sem+ins properties, got: "
                                 + "; ".join(property_lines))
        vertex_count = 0
        for ln in header_lines:
            if ln.startswith("element vertex"):
                vertex_count = int(ln.split()[-1])
        if vertex_count <= 0:
            raise AssertionError("no vertices")
        xyz = np.empty((vertex_count, 3), np.float32)
        sem = np.empty(vertex_count, np.uint16)
        ins = np.empty(vertex_count, np.uint16)
        for i in range(vertex_count):
            rec = f.read(19)
            if len(rec) != 19:
                raise AssertionError(f"truncated record at vertex {i}")
            xyz[i] = struct.unpack("fff", rec[:12])
            sem[i], ins[i] = struct.unpack("HH", rec[15:19])
        if f.read(1) != b"":
            raise AssertionError("trailing bytes after vertex payload")
    return {"header": header_lines, "xyz": xyz, "sem": sem, "ins": ins}


def gate_config(root: Path, tag: str):
    """The gate's pipeline config (BLK2GO, 20 waypoints, voxel 0.04, no
    figures) writing under ``root``."""
    from ipcgen_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.data.data_root = str(FIXTURE)
    cfg.data.output_root = str(root / f"outputs{tag}")
    cfg.data.area_name = AREA
    cfg.data.room_name = ROOM
    cfg.nksr.voxel_size = 0.04
    cfg.nksr.chunked = False
    cfg.preprocessing.normal_search_radius = 0.3
    cfg.simulation.num_waypoints = 20
    cfg.simulation.use_blk2go = True
    cfg.simulation.use_auto_trajectory = True
    cfg.simulation.save_visualizations = False
    cfg.simulation.output_base_dir = str(root / f"simulation_results{tag}")
    return cfg


def run_pass(root: Path, tag: str, device=None):
    """All five stages; returns (per-stage seconds, sim_root, eval_txt)."""
    from ipcgen_tpu_torch.run_pipeline import run
    from ipcgen_tpu_torch.utils.device import sync

    cfg = gate_config(root, tag)
    sim_root = Path(cfg.simulation.output_base_dir)
    stage_seconds = {}
    eval_txt = root / f"single_scene_evaluation{tag}.txt"
    for stage in ("preprocess", "recon", "sim", "bbox", "eval"):
        t0 = time.time()
        if stage == "eval":
            # A LiDAR-Net candidate built from the fixture's annotations.
            from ipcgen_tpu_torch.bbox.detection import LIDAR_NET_SEMANTIC_MAPPING
            from ipcgen_tpu_torch.eval.evaluate import find_best_match, write_evaluation_report
            from ipcgen_tpu_torch.io.ply import write_labeled_ply

            ann_dir = FIXTURE / AREA / ROOM / "Annotations"
            pts, rgb, sem, ins = [], [], [], []
            for cls, sem_id in LIDAR_NET_SEMANTIC_MAPPING.items():
                for k, f in enumerate(sorted(ann_dir.glob(f"{cls}_*.txt")), start=1):
                    rows = np.loadtxt(f)
                    pts.append(rows[:, :3].astype(np.float32))
                    rgb.append(rows[:, 3:6].astype(np.uint8))
                    sem.append(np.full(len(rows), sem_id, np.uint16))
                    ins.append(np.full(len(rows), k, np.uint16))
            ln_scene = root / f"lidar_net{tag}" / "lounge_scan_01"
            ln_scene.mkdir(parents=True)
            write_labeled_ply(ln_scene / "lounge_scan_01.ply", np.vstack(pts), np.vstack(rgb),
                              np.concatenate(sem), np.concatenate(ins))
            labeled = sim_root / SCENE / "combined_pointcloud_with_label.ply"
            result = find_best_match(str(labeled), str(root / f"lidar_net{tag}"), 4000, 0.9,
                                     10, device=device)
            if result is None:
                raise AssertionError("no volume-compatible eval candidate")
            write_evaluation_report(result, str(eval_txt), elapsed=1.0)
        else:
            entry = run(cfg, [stage], device=device)["rooms"][SCENE]
            if "error" in entry:
                raise AssertionError(f"{stage}: {entry}")
        sync(device)
        stage_seconds[stage] = time.time() - t0
    return stage_seconds, sim_root, eval_txt


def run_gate(passes: int = 2, device=None, root=None) -> dict:
    """``passes`` runs of the five stages in a new directory under ``root``
    (a temporary one when None), the parity checks on the last; returns the
    gate's record (seconds of the first and the last pass)."""
    root = Path(tempfile.mkdtemp(prefix="release_gate_", dir=root))
    try:
        runs = [run_pass(root, "" if i == 0 else f"_p{i}", device)
                for i in range(max(passes, 1))]
        stage_seconds, sim_root, eval_txt = runs[-1]
        scene_dir = sim_root / SCENE
        data = reference_read_labeled_ply(scene_dir / "combined_pointcloud_with_label.ply")
        if len(data["xyz"]) <= 50_000:
            raise AssertionError(f"{len(data['xyz'])} labeled points")
        with open(scene_dir / f"{SCENE}_detection_annotations.json") as f:
            doc = json.load(f)
        if doc["metadata"]["framework"] != "Group-Free-3D" or \
                doc["metadata"]["total_objects"] < 1:
            raise AssertionError(f"detection JSON metadata {doc['metadata']}")
        if not (scene_dir / "simulation_statistics.txt").read_text().startswith(
                "Simulation Statistics"):
            raise AssertionError("simulation_statistics.txt")
        if "Evaluation Results:" not in eval_txt.read_text():
            raise AssertionError("evaluation report")
        return {
            "gate": "lroom_five_stage",
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "stage_seconds_cold": runs[0][0],
            "stage_seconds_steady": stage_seconds,
            "total_seconds_cold": sum(runs[0][0].values()),
            "total_seconds_steady": sum(stage_seconds.values()),
            "passes": len(runs),
            "labeled_points": int(len(data["xyz"])),
            "detection_objects": int(doc["metadata"]["total_objects"]),
            "parity": "ok",
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json-out", default=None, help="also write the gate JSON to this path")
    ap.add_argument("--passes", type=int, default=2,
                    help="in-process passes; the first cold, the last steady")
    args = ap.parse_args(argv)

    from ipcgen_tpu_torch.utils.device_probe import probe_device

    platform = probe_device()
    if platform is None:
        print(json.dumps({"error": "no card answered the device probe"}))
        raise SystemExit(2)
    from ipcgen_tpu_torch.utils.device import card_line

    out = dict(run_gate(args.passes), platform=platform, card=card_line())
    print(json.dumps(out))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
