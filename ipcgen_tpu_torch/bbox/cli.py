"""Detection-box CLIs (port of ``ipcgen_tpu/bbox/cli.py``; reference mains:
s3dis_bbox_visualizer.py:574-661 and lidar_net_bbox_visualizer.py:817-898).

    python -m ipcgen_tpu_torch.bbox.cli --data_root S3DIS [--area_name A --room_name R]

Both mains run the outlier removal on the card; ``device="cpu"`` runs it on
the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ipcgen_tpu_torch.bbox.detection import LiDARNetBBoxVisualizer, S3DISBBoxVisualizer


def main_s3dis(argv=None, device=None):
    """Boxes from S3DIS annotation txt trees (reference: :574-661)."""
    parser = argparse.ArgumentParser(
        description="S3DIS bounding box generation (Group-Free-3D JSON)"
    )
    parser.add_argument("--data_root", type=str, required=True)
    parser.add_argument("--area_name", type=str, default=None)
    parser.add_argument("--room_name", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--results_root", type=str, default="simulation_results")
    parser.add_argument("--process_all_areas", action="store_true")
    args = parser.parse_args(argv)

    data_root = Path(args.data_root)
    if not data_root.exists():
        print(f"[Error] Data root directory does not exist: {data_root}")
        return None
    visualizer = S3DISBBoxVisualizer(results_root=args.results_root, device=device)

    if args.process_all_areas:
        total = 0
        for i in range(1, 7):
            area_path = data_root / f"Area_{i}"
            if area_path.exists():
                bboxes = visualizer.process_area(area_path)
                total += len(bboxes or [])
        print(f"[Main] All areas processed. Total bounding boxes: {total}")
        return total
    if args.area_name and args.room_name:
        room_path = data_root / args.area_name / args.room_name
        bboxes = visualizer.visualize_room_bboxes(room_path)
        print(f"[Main] Room processed: {len(bboxes or [])} bounding boxes")
        return bboxes
    if args.area_name:
        bboxes = visualizer.process_area(data_root / args.area_name)
        print(f"[Main] Area processed: {len(bboxes or [])} bounding boxes")
        return bboxes
    # Default: first room found (reference: :643-661)
    for i in range(1, 7):
        area_path = data_root / f"Area_{i}"
        if area_path.exists():
            rooms = sorted(d for d in area_path.iterdir() if d.is_dir())
            if rooms:
                bboxes = visualizer.visualize_room_bboxes(rooms[0])
                print(f"[Main] Room processed: {len(bboxes or [])} bounding boxes")
                return bboxes
    return None


def main_lidar_net(argv=None, device=None):
    """Boxes from labeled PLYs (reference: lidar_net_bbox_visualizer.py:817-898)."""
    parser = argparse.ArgumentParser(
        description="LiDAR-Net bounding box generation from labeled PLYs"
    )
    parser.add_argument("--data_root", type=str, default=".")
    parser.add_argument("--ply", type=str, default=None, help="single PLY file")
    parser.add_argument("--results_root", type=str, default="simulation_results")
    args = parser.parse_args(argv)

    visualizer = LiDARNetBBoxVisualizer(results_root=args.results_root, device=device)
    if args.ply:
        bboxes = visualizer.process_room_instances(Path(args.ply))
        print(f"[Main] {args.ply}: {len(bboxes or [])} bounding boxes")
        return bboxes
    bboxes = visualizer.process_area(Path(args.data_root))
    print(f"[Main] Processed {len(bboxes)} bounding boxes total")
    return bboxes


if __name__ == "__main__":
    main_s3dis()
