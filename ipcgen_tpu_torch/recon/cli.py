"""Reconstruction CLI: preprocessed pickle -> per-variant meshes + report
(port of ``ipcgen_tpu/recon/cli.py``).

For each sparsity variant in the preprocessed room pickle: reconstruct, save
mesh_<variant>.ply + .json stats, optionally draw the projections and
evaluate, and write reconstruction_report.json + reconstruction_summary.txt.

    python -m ipcgen_tpu_torch.recon.cli --config configs/s3dis_config.yaml \\
        --data_path ROOM.pkl [--output_dir DIR] [--sparsity dense]

Runs on the card; ``main(argv, device="cpu")`` runs on the CPU.  yaml is
imported only inside ``main``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Dict

from ipcgen_tpu_torch.recon.projection_viz import ReconstructionVisualizer
from ipcgen_tpu_torch.recon.reconstructor import S3DISEvaluator, S3DISReconstructor


def save_experiment_report(results: Dict, output_dir: Path, room_info: Dict) -> None:
    """reconstruction_report.json + summary table (reference: :352-393)."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    report = {
        "room_info": room_info,
        "experiment_time": time.strftime("%Y-%m-%d %H:%M:%S"),
        "results": results,
    }
    with open(output_dir / "reconstruction_report.json", "w", encoding="utf-8") as f:
        json.dump(report, f, indent=2, ensure_ascii=False)

    with open(output_dir / "reconstruction_summary.txt", "w", encoding="utf-8") as f:
        f.write("S3DIS Reconstruction Summary\n")
        f.write("=" * 80 + "\n\n")
        f.write(
            f"{'Config':<15} {'InputPts':<10} {'Vertices':<10} {'Faces':<10} "
            f"{'Time(s)':<10} {'EvalStatus':<12}\n"
        )
        f.write("-" * 80 + "\n")
        for config_name, result in results.items():
            if "error" in result:
                f.write(
                    f"{config_name:<15} {'ERROR':<10} {'ERROR':<10} {'ERROR':<10} "
                    f"{'ERROR':<10} {'ERROR':<12}\n"
                )
                continue
            rs = result.get("reconstruction_stats", {})
            qm = result.get("quality_metrics", {})
            eval_status = "skipped" if not qm else "done"
            f.write(
                f"{config_name:<15} "
                f"{rs.get('input_points', 0):<10} "
                f"{rs.get('output_vertices', 0):<10} "
                f"{rs.get('output_faces', 0):<10} "
                f"{rs.get('reconstruction_time', 0):<10.2f} "
                f"{eval_status:<12}\n"
            )


def reconstruct_room(
    data_path: str,
    config: Dict,
    output_dir: str,
    sparsity: str = None,
    span_sink: Dict = None,
    *,
    device=None,
) -> Dict:
    """Per-variant reconstruction loop (reference main: :396-499) on
    ``device`` (None: the card).  A variant that fails is recorded with its
    error in the report and printed, as in the JAX package."""
    from ipcgen_tpu_torch.preprocess.loader import load_preprocessed_data

    stage_spans: Dict[str, float] = {}
    t0 = time.time()
    room_data = load_preprocessed_data(data_path)
    stage_spans["load_pickle"] = time.time() - t0
    output_dir = Path(output_dir)
    scene_dir = output_dir / f"{room_data['area']}_{room_data['room']}"
    scene_dir.mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    reconstructor = S3DISReconstructor(config, device=device)
    evaluator = S3DISEvaluator(config, device=device)
    visualizer = ReconstructionVisualizer(config)
    stage_spans["init"] = time.time() - t0
    results: Dict = {}
    variants = room_data.get("variants", {})
    if sparsity:
        variants = {k: v for k, v in variants.items() if k == sparsity}

    for name, variant in variants.items():
        try:
            t0 = time.time()
            mesh, stats = reconstructor.reconstruct_mesh(
                variant["points"],
                normals=variant.get("normals"),
                colors=variant.get("colors"),
            )
            stage_spans["recon"] = stage_spans.get("recon", 0.0) + (
                time.time() - t0)
            t0 = time.time()
            mesh_path = scene_dir / f"mesh_{name}.ply"
            reconstructor.save_mesh(mesh, mesh_path, stats)
            stage_spans["save_mesh"] = stage_spans.get("save_mesh", 0.0) + (
                time.time() - t0)
            # Per-variant projection PNGs (reference: s3dis_nksr_reconstructor
            # .py:158-264, called from its main loop), gated by
            # visualization.save_visualizations.
            visualizer.visualize_pointcloud(
                variant["points"], colors=variant.get("colors"),
                output_path=scene_dir / f"projection_points_{name}.png",
                title=f"Input Points ({name})",
            )
            visualizer.visualize_mesh_projection(
                mesh,
                output_path=scene_dir / f"projection_mesh_{name}.png",
                title=f"Reconstructed Mesh ({name})",
            )
            entry = {"reconstruction_stats": stats, "mesh_path": str(mesh_path)}
            eval_cfg = config.get("evaluation", {})
            if eval_cfg.get("compute_chamfer") or eval_cfg.get("compute_mesh_quality"):
                entry["quality_metrics"] = evaluator.evaluate_reconstruction_quality(
                    mesh, variant["points"]
                )
            else:
                entry["quality_metrics"] = {}
            results[name] = entry
            span_txt = " ".join(
                f"{k}={v:.1f}" for k, v in stats.get("spans", {}).items()
            )
            print(
                f"[Recon] {name}: {stats['input_points']} pts -> "
                f"{stats['output_faces']} faces in "
                f"{stats['reconstruction_time']:.2f}s ({span_txt})"
            )
        except Exception as e:  # the report records each variant's failure
            results[name] = {"error": str(e)}
            print(f"[Recon] {name} failed: {e}")

    t0 = time.time()
    save_experiment_report(
        results,
        scene_dir,
        {"area": room_data["area"], "room": room_data["room"]},
    )
    stage_spans["report"] = time.time() - t0
    # `recon` here is the full reconstruct_mesh wall incl. host <-> device
    # copies; the finer fuse/march/... spans print per variant above.
    print("  recon stage sub-spans: "
          + " ".join(f"{k}={v:.1f}" for k, v in stage_spans.items()),
          flush=True)
    if span_sink is not None:
        span_sink.update(stage_spans)
        # Device-op spans of the last variant (fuse/march/weld/imls/...)
        # so callers can persist the full attribution, not just the wall.
        for r in results.values():
            for k, v in r.get("reconstruction_stats", {}).get(
                    "spans", {}).items():
                span_sink[f"op_{k}"] = v
    return results


def main(argv=None, device=None):
    parser = argparse.ArgumentParser(description="S3DIS surface reconstruction")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--data_path", type=str, required=True,
                        help="preprocessed room pickle")
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--sparsity", type=str, default=None,
                        help="only reconstruct this variant")
    args = parser.parse_args(argv)

    import yaml

    with open(args.config, "r", encoding="utf-8") as f:
        config = yaml.safe_load(f)
    output_dir = args.output_dir or Path(
        config.get("data", {}).get("output_root", "outputs/s3dis_reconstruction")
    ) / "reconstruction_results"
    return reconstruct_room(args.data_path, config, str(output_dir), args.sparsity,
                            device=device)


if __name__ == "__main__":
    main()
