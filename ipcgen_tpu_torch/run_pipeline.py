"""End-to-end pipeline driver: S3DIS rooms -> labeled mobile-LiDAR datasets
(port of ``scripts/run_pipeline.py``).

Chains the five stages over a data root:

  preprocess -> reconstruct -> simulate -> bbox -> evaluate

Every stage is restartable at file granularity (existing outputs are
skipped) and failures are recorded per room without aborting the batch; the
report goes to ``<output_root>/pipeline_report.json``.

    python -m ipcgen_tpu_torch.run_pipeline --config configs/s3dis_config.yaml \\
        [--area Area_1] [--room office_1] [--stages preprocess,recon,sim,bbox,eval]

``main`` loads the YAML (yaml is imported there only) and calls ``run``,
which takes the config tree itself: hosts without yaml call ``run``.  Every
stage runs on ``device`` (None: the card).
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict, Iterable

from ipcgen_tpu_torch.config import PipelineConfig

STAGES = ("preprocess", "recon", "sim", "bbox", "eval")


def run(cfg: PipelineConfig, stages: Iterable[str] = STAGES, device=None) -> Dict:
    """Run ``stages`` of the pipeline over ``cfg``'s area (or its one room);
    returns the report that is also written to ``pipeline_report.json``:
    ``{"rooms": {scene: {stage: status, ["error": message]}}, "started",
    "total_seconds", "rooms_per_hour"}``."""
    from ipcgen_tpu_torch.preprocess.loader import S3DISLoader, preprocess_room

    stages = set(stages)
    out_root = Path(cfg.data.output_root)
    pre_dir = out_root / "preprocessed"
    recon_dir = out_root / "reconstruction_results"
    sim_dir = Path(cfg.simulation.output_base_dir)
    report = {"rooms": {}, "started": time.strftime("%Y-%m-%d %H:%M:%S")}
    t_start = time.time()

    loader = S3DISLoader(cfg.data.data_root)
    rooms = (
        [cfg.data.room_name]
        if cfg.data.room_name
        else loader.get_available_rooms(cfg.data.area_name)
    )
    area = cfg.data.area_name
    print(f"[Pipeline] {area}: {len(rooms)} rooms, stages: {sorted(stages)}")

    for room in rooms:
        entry = {}
        scene_name = f"{area}_{room}"
        try:
            pkl = pre_dir / f"{area}_{room}_preprocessed.pkl"
            if "preprocess" in stages:
                if pkl.exists():
                    entry["preprocess"] = "skipped (exists)"
                else:
                    preprocess_room(
                        cfg.data.data_root, area, room, cfg.to_dict(),
                        output_dir=str(pre_dir),
                        sparsity_experiments=[
                            dict(name=s.name, keep_ratio=s.keep_ratio,
                                 occlusion=s.occlusion)
                            for s in cfg.sparsity_experiments
                        ],
                        seed=cfg.simulation.seed, device=device,
                    )
                    entry["preprocess"] = "done"

            if "sim" in stages:
                # Start the room's label prefetch now, so its parse and grid
                # build hide behind the recon stage.
                from ipcgen_tpu_torch.containers.sim_scene import prewarm_labels

                prewarm_labels(cfg.data.data_root, area, room, device=device)

            mesh_path = recon_dir / scene_name / "mesh_dense.ply"
            if "recon" in stages:
                if mesh_path.exists():
                    entry["recon"] = "skipped (exists)"
                else:
                    from ipcgen_tpu_torch.recon.cli import reconstruct_room

                    reconstruct_room(str(pkl), cfg.to_dict(), str(recon_dir),
                                     device=device)
                    entry["recon"] = "done"

            labeled_ply = sim_dir / scene_name / "combined_pointcloud_with_label.ply"
            if "sim" in stages:
                stats_txt = sim_dir / scene_name / "simulation_statistics.txt"
                if labeled_ply.exists() and stats_txt.exists():
                    entry["sim"] = "skipped (exists)"
                else:
                    from ipcgen_tpu_torch.sim.simulator import run_single_scene_simulation

                    run_single_scene_simulation(
                        scene_path=str(mesh_path),
                        scene_name=scene_name,
                        num_waypoints=cfg.simulation.num_waypoints,
                        output_base_dir=str(sim_dir),
                        use_gpu=cfg.simulation.use_gpu,
                        robot_height=cfg.simulation.robot_height,
                        use_dense_lidar=cfg.simulation.use_dense_lidar,
                        use_blk2go=cfg.simulation.use_blk2go,
                        use_auto_trajectory=cfg.simulation.use_auto_trajectory,
                        s3dis_data_root=cfg.data.data_root,
                        area=area,
                        room=room,
                        seed=cfg.simulation.seed,
                        save_visualizations=cfg.simulation.save_visualizations,
                        lidar_horizontal_res=cfg.simulation.lidar_horizontal_res,
                        device=device,
                    )
                    entry["sim"] = "done"

            if "bbox" in stages:
                json_path = sim_dir / scene_name / f"{scene_name}_detection_annotations.json"
                if json_path.exists():
                    entry["bbox"] = "skipped (exists)"
                else:
                    from ipcgen_tpu_torch.bbox.detection import S3DISBBoxVisualizer

                    vis = S3DISBBoxVisualizer(results_root=str(sim_dir), device=device)
                    room_path = Path(cfg.data.data_root) / area / room
                    bboxes = vis.visualize_room_bboxes(room_path)
                    entry["bbox"] = f"done ({len(bboxes or [])} boxes)"

            if "eval" in stages:
                eval_out = Path("evaluation_results") / scene_name
                result_file = eval_out / "single_scene_evaluation.txt"
                if result_file.exists():
                    entry["eval"] = "skipped (exists)"
                elif labeled_ply.exists():
                    from ipcgen_tpu_torch.eval.evaluate import (
                        find_best_match,
                        write_evaluation_report,
                    )

                    t0 = time.time()
                    result = find_best_match(
                        str(labeled_ply), str(sim_dir), cfg.evaluation.max_points,
                        cfg.evaluation.volume_threshold, cfg.evaluation.max_candidates,
                        device=device,
                    )
                    if result:
                        eval_out.mkdir(parents=True, exist_ok=True)
                        write_evaluation_report(result, str(result_file), time.time() - t0,
                                                cfg.evaluation.volume_threshold)
                        entry["eval"] = "done"
                    else:
                        entry["eval"] = "no compatible scene"
        except Exception as e:
            entry["error"] = str(e)
            print(f"[Pipeline] {scene_name} failed: {e}")
        report["rooms"][scene_name] = entry
        print(f"[Pipeline] {scene_name}: {entry}")

    report["total_seconds"] = time.time() - t_start
    n_done = sum(1 for r in report["rooms"].values() if "error" not in r)
    if report["total_seconds"] > 0:
        report["rooms_per_hour"] = n_done / report["total_seconds"] * 3600
    out_root.mkdir(parents=True, exist_ok=True)
    with open(out_root / "pipeline_report.json", "w") as f:
        json.dump(report, f, indent=2)
    print(f"[Pipeline] {n_done}/{len(rooms)} rooms in {report['total_seconds']:.1f}s")
    return report


def main(argv=None, device=None) -> Dict:
    """The command line: load ``--config`` (YAML), apply ``--area`` and
    ``--room``, and ``run`` the ``--stages`` on ``device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="configs/s3dis_config.yaml")
    ap.add_argument("--area", default=None)
    ap.add_argument("--room", default=None)
    ap.add_argument("--stages", default=",".join(STAGES))
    args = ap.parse_args(argv)
    cfg = PipelineConfig.load(args.config)
    if args.area:
        cfg.data.area_name = args.area
    if args.room:
        cfg.data.room_name = args.room
    return run(cfg, args.stages.split(","), device=device)


if __name__ == "__main__":
    main()
