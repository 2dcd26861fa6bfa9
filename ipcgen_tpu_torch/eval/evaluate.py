"""Single-scene distribution evaluation (MMD / Chamfer / Hausdorff / density)
(port of ``ipcgen_tpu/eval/evaluate.py``).

API-parity rewrite of reference evaluate_single_scene.py:15-357 with the
metrics on ``device`` (None: the card; ``ipcgen_tpu_torch.ops.metrics``).
Given a simulated S3DIS cloud, finds a volume-compatible real LiDAR-Net cloud
and reports the four paper metrics (reference README.md:131-135).

    python -m ipcgen_tpu_torch.eval.evaluate --s3dis_ply SIM.ply --data_root DIR

``main(argv, device="cpu")`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np

from ipcgen_tpu_torch.io.ply import read_point_cloud
from ipcgen_tpu_torch.ops import metrics as M


def load_point_cloud(ply_path: str) -> Optional[np.ndarray]:
    """Load xyz from any PLY (reference: :15-23)."""
    try:
        points, _, _ = read_point_cloud(ply_path)
        return points
    except Exception as e:
        print(f"[Error] Failed to load point cloud {ply_path}: {e}")
        return None


def normalize_coordinates(points: np.ndarray, method: str = "center") -> np.ndarray:
    """Coordinate normalization (reference: :25-45)."""
    if method in ("center", "zero_center"):
        center = (points.min(axis=0) + points.max(axis=0)) / 2
        return points - center
    if method == "min":
        return points - points.min(axis=0)
    return points


def sample_points(points: np.ndarray, max_points: int = 10000) -> np.ndarray:
    return M.sample_points(points, max_points)


def compute_mmd_sampled(x, y, max_points: int = 10000, gamma: float = 1.0, *,
                        device=None) -> float:
    return M.compute_mmd(x, y, max_points=max_points, gamma=gamma, device=device)


def compute_chamfer_distance(x, y, *, device=None) -> float:
    return M.compute_chamfer_distance(x, y, max_points=5000, device=device)


def compute_hausdorff_distance(x, y, *, device=None) -> float:
    return M.compute_hausdorff_distance(x, y, max_points=3000, device=device)


def analyze_point_cloud(points: np.ndarray, name: str, normalize: bool = True) -> Dict:
    """Basic features: count, bbox volume, density (reference: :113-133)."""
    normalized = normalize_coordinates(points, "zero_center") if normalize else points
    extent = normalized.max(axis=0) - normalized.min(axis=0)
    volume = float(np.prod(extent))
    return {
        "count": len(points),
        "volume": volume,
        "density": len(normalized) / volume if volume > 0 else 0,
        "normalized_points": normalized,
    }


def check_volume_compatibility(volume1: float, volume2: float, threshold: float = 0.3):
    """Relative volume gate (reference: :135-140)."""
    volume_diff = abs(volume1 - volume2) / max(volume1, volume2)
    return volume_diff <= threshold, volume_diff


def find_lidar_net_scenes(data_root: str) -> List[Dict]:
    """Scan for LiDAR-Net scene dirs, skipping S3DIS 'Area*' dirs
    (reference: :142-163)."""
    lidar_net_scenes = []
    if not os.path.exists(data_root):
        print(f"[Error] Data root directory does not exist: {data_root}")
        return lidar_net_scenes
    for item in sorted(os.listdir(data_root)):
        item_path = os.path.join(data_root, item)
        if os.path.isdir(item_path) and "Area" not in item:
            ply_file = os.path.join(item_path, f"{item}.ply")
            if os.path.exists(ply_file):
                lidar_net_scenes.append(
                    {"name": item, "path": item_path, "ply_file": ply_file}
                )
    return lidar_net_scenes


def evaluate_single_scene(
    s3dis_ply: str,
    lidar_net_ply: str,
    max_points: int = 10000,
    volume_threshold: float = 0.3,
    *,
    device=None,
) -> Optional[Dict]:
    """Four-metric comparison of one scene pair (reference: :165-208), the
    metrics on ``device`` (None: the card)."""
    s3dis_points = load_point_cloud(s3dis_ply)
    lidar_net_points = load_point_cloud(lidar_net_ply)
    if s3dis_points is None or lidar_net_points is None:
        return None

    s3dis_stats = analyze_point_cloud(s3dis_points, "S3DIS", normalize=True)
    lidar_net_stats = analyze_point_cloud(lidar_net_points, "LiDAR-Net", normalize=True)
    is_compatible, volume_diff = check_volume_compatibility(
        s3dis_stats["volume"], lidar_net_stats["volume"], volume_threshold
    )
    if not is_compatible:
        return None

    x = s3dis_stats["normalized_points"]
    y = lidar_net_stats["normalized_points"]
    mmd = compute_mmd_sampled(x, y, max_points, device=device)
    cd = compute_chamfer_distance(x, y, device=device)
    hd = compute_hausdorff_distance(x, y, device=device)
    density_ratio = s3dis_stats["density"] / lidar_net_stats["density"]

    return {
        "mmd": mmd,
        "cd": cd,
        "hd": hd,
        "density_ratio": density_ratio,
        "s3dis_points": len(s3dis_points),
        "lidar_net_points": len(lidar_net_points),
        "s3dis_density": s3dis_stats["density"],
        "lidar_net_density": lidar_net_stats["density"],
        "s3dis_volume": s3dis_stats["volume"],
        "lidar_net_volume": lidar_net_stats["volume"],
        "volume_diff": volume_diff,
    }


def find_best_match(
    s3dis_ply: str,
    data_root: str,
    max_points: int = 10000,
    volume_threshold: float = 0.3,
    max_candidates: int = 50,
    rng: Optional[random.Random] = None,
    *,
    device=None,
) -> Optional[Dict]:
    """First volume-compatible LiDAR-Net scene among shuffled candidates
    (reference: :210-270)."""
    s3dis_points = load_point_cloud(s3dis_ply)
    if s3dis_points is None:
        return None
    s3dis_volume = analyze_point_cloud(s3dis_points, "S3DIS", normalize=True)["volume"]

    lidar_net_scenes = find_lidar_net_scenes(data_root)
    if not lidar_net_scenes:
        print("[Error] No LiDAR-Net scenes found")
        return None
    candidates = lidar_net_scenes[:max_candidates]
    (rng or random).shuffle(candidates)

    best_match = None
    for scene in candidates:
        pts = load_point_cloud(scene["ply_file"])
        if pts is None:
            continue
        extent = pts.max(axis=0) - pts.min(axis=0)
        lidar_net_volume = float(np.prod(extent))
        volume_diff = abs(s3dis_volume - lidar_net_volume) / max(
            s3dis_volume, lidar_net_volume
        )
        if volume_diff <= volume_threshold:
            result = evaluate_single_scene(
                s3dis_ply, scene["ply_file"], max_points, volume_threshold, device=device
            )
            if result:
                result["s3dis_scene"] = os.path.basename(s3dis_ply)
                result["lidar_net_scene"] = scene["name"]
                result["lidar_net_ply"] = scene["ply_file"]
                best_match = result
                break  # first compatible wins (reference: :259-263)
    if not best_match:
        print("[Warning] No volume-compatible LiDAR-Net scene found")
    return best_match


def write_evaluation_report(result: Dict, output_file: str, elapsed: float,
                            volume_threshold: float = 0.3) -> None:
    """Text report in the reference layout (reference: :317-343)."""
    with open(output_file, "w") as f:
        f.write("Single Scene Virtual LiDAR Point Cloud Distribution Evaluation Results\n")
        f.write("=" * 50 + "\n")
        f.write(f"Evaluation time: {time.strftime('%Y-%m-%d %H:%M:%S')}\n")
        f.write(f"Total time: {elapsed:.2f} seconds\n")
        f.write("Evaluation metrics: MMD + CD + HD + density analysis\n")
        f.write(
            f"Improvements: coordinate normalization + volume filtering "
            f"(threshold: {volume_threshold:.1%})\n\n"
        )
        f.write(f"S3DIS scene: {result['s3dis_scene']}\n")
        f.write(f"LiDAR-Net scene: {result['lidar_net_scene']}\n")
        f.write(f"LiDAR-Net file: {result['lidar_net_ply']}\n\n")
        f.write("Evaluation Results:\n")
        f.write(f"  MMD: {result['mmd']:.4f} (spatial distribution similarity)\n")
        f.write(f"  CD: {result['cd']:.4f} (overall aggregation)\n")
        f.write(f"  HD: {result['hd']:.4f} (local aggregation)\n")
        f.write(
            f"  Density ratio: {result['density_ratio']:.4f} "
            f"(S3DIS density / LiDAR-Net density)\n"
        )
        f.write(f"  Volume difference: {result['volume_diff']:.2%}\n\n")
        f.write("Point Cloud Statistics:\n")
        f.write(f"  S3DIS points: {result['s3dis_points']:,}\n")
        f.write(f"  LiDAR-Net points: {result['lidar_net_points']:,}\n")
        f.write(f"  S3DIS density: {result['s3dis_density']:.2f} points/m³\n")
        f.write(f"  LiDAR-Net density: {result['lidar_net_density']:.2f} points/m³\n")
        f.write(f"  S3DIS volume: {result['s3dis_volume']:.2f}\n")
        f.write(f"  LiDAR-Net volume: {result['lidar_net_volume']:.2f}\n")


def main(argv=None, device=None):
    """CLI entry (reference: :272-357)."""
    parser = argparse.ArgumentParser(
        description=(
            "Single scene virtual LiDAR point cloud distribution evaluation — "
            "specify S3DIS, automatically find matching LiDAR-Net"
        )
    )
    parser.add_argument("--s3dis_ply", required=True)
    parser.add_argument("--data_root", default="simulation_results")
    parser.add_argument("--output_dir", default="evaluation_results")
    parser.add_argument("--max_points", type=int, default=10000)
    parser.add_argument("--volume_threshold", type=float, default=0.3)
    parser.add_argument("--max_candidates", type=int, default=50)
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    start_time = time.time()
    if not os.path.exists(args.s3dis_ply):
        print(f"[Error] S3DIS file does not exist: {args.s3dis_ply}")
        return None
    result = find_best_match(
        args.s3dis_ply,
        args.data_root,
        args.max_points,
        args.volume_threshold,
        args.max_candidates,
        device=device,
    )
    if result is None:
        print("[Error] No suitable matching scene found")
        return None
    output_file = os.path.join(args.output_dir, "single_scene_evaluation.txt")
    write_evaluation_report(
        result, output_file, time.time() - start_time, args.volume_threshold
    )
    print(f"[Evaluation] Results saved to: {output_file}")
    return result


if __name__ == "__main__":
    main()
