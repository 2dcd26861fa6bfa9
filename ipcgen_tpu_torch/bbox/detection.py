"""3D bounding-box generation from annotations and labeled clouds (port of
``ipcgen_tpu/bbox/detection.py``).

API-parity rewrite of reference s3dis_bbox_visualizer.py:16-665 and
lidar_net_bbox_visualizer.py:16-902:

- ``S3DISBBoxVisualizer``    — boxes from S3DIS per-instance annotation txt
  files (outlier removal on ``device``, AABB + quality gates, Group-Free-3D
  JSON into simulation_results/<scene>/).
- ``LiDARNetBBoxVisualizer`` — boxes from the 8-attribute labeled PLY
  (semantic+instance split, same gates/JSON), read by the port's PLY codec.

The JSON schema matches the reference field-for-field so VoteNet /
Group-Free-3D tooling consumes the outputs unchanged
(s3dis_bbox_visualizer.py:499-571).  The statistical outlier removal runs on
the visualizers' ``device`` (None: the card); matplotlib is imported only to
draw.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ipcgen_tpu_torch.io.ply import read_labeled_ply
from ipcgen_tpu_torch.ops.outliers import remove_statistical_outliers
from ipcgen_tpu_torch.utils.device import device_or_card

# Detection classes, excluding door (reference: s3dis_bbox_visualizer.py:21-23)
DETECTION_CLASSES = {"window", "table", "chair", "sofa", "bookcase", "board", "stairs"}

# Group-Free-3D compatible class remap (reference: :502-510)
CLASS_NAME_MAPPING = {
    "window": "window",
    "table": "table",
    "chair": "chair",
    "sofa": "sofa",
    "bookcase": "bookshelf",
    "board": "picture",
    "stairs": "counter",
}

# LiDAR-Net semantic ids (reference: lidar_net_bbox_visualizer.py:26-34)
LIDAR_NET_SEMANTIC_MAPPING = {
    "window": 15,
    "table": 18,
    "chair": 19,
    "sofa": 20,
    "bookcase": 23,
    "board": 21,
    "stairs": 10,
}

CLASS_COLORS = {
    "window": [1.0, 0.0, 0.0],
    "table": [0.0, 0.0, 1.0],
    "chair": [1.0, 1.0, 0.0],
    "sofa": [1.0, 0.0, 1.0],
    "bookcase": [0.0, 1.0, 1.0],
    "board": [1.0, 0.5, 0.0],
    "stairs": [0.5, 0.0, 1.0],
}

DEFAULT_BBOX_PARAMS = {
    "min_points": 10,
    "min_volume": 0.001,
    "max_aspect_ratio": 10.0,
    "max_vis_points": 1000,
}


def calculate_bbox(points: np.ndarray) -> Optional[Dict]:
    """Axis-aligned box: center/size/volume/aspect (reference: :94-116)."""
    if len(points) == 0:
        return None
    min_coords = points.min(axis=0)
    max_coords = points.max(axis=0)
    center = (min_coords + max_coords) / 2
    size = max_coords - min_coords
    volume = float(np.prod(size))
    sorted_size = np.sort(size)
    aspect_ratio = (
        float(sorted_size[2] / sorted_size[0]) if sorted_size[0] > 0 else float("inf")
    )
    return {
        "center": center,
        "size": size,
        "min_coords": min_coords,
        "max_coords": max_coords,
        "volume": volume,
        "aspect_ratio": aspect_ratio,
        "point_count": len(points),
    }


def generate_detection_annotations(
    bboxes: List[Dict], output_path: Path, dataset: str = "S3DIS"
) -> List[Dict]:
    """Write the Group-Free-3D compatible JSON (reference: :499-571)."""
    detection_annotations = []
    for i, bbox in enumerate(bboxes):
        original_class = bbox["object_name"]
        groupfree_class = CLASS_NAME_MAPPING.get(original_class, original_class)
        ann = {
            "instance_id": i + 1,
            "class_name": groupfree_class,
            "original_class_name": original_class,
            "bbox_3d": {
                "center": np.asarray(bbox["center"]).tolist(),
                "size": np.asarray(bbox["size"]).tolist(),
                "rotation": [0, 0, 0],
                "min_coords": np.asarray(bbox["min_coords"]).tolist(),
                "max_coords": np.asarray(bbox["max_coords"]).tolist(),
            },
            "point_count": int(bbox["point_count"]),
            "volume": float(bbox["volume"]),
            "aspect_ratio": float(bbox["aspect_ratio"]),
            "confidence": 1.0,
            "bbox_format": "AABB",
            "coordinate_system": "world",
            "units": "meters",
            "framework": "Group-Free-3D",
        }
        detection_annotations.append(ann)

    annotation_file = {
        "metadata": {
            "dataset": dataset,
            "annotation_type": "3D_object_detection",
            "framework": "Group-Free-3D",
            "classes": list(CLASS_NAME_MAPPING.values()),
            "original_classes": list(CLASS_NAME_MAPPING.keys()),
            "class_mapping": CLASS_NAME_MAPPING,
            "bbox_format": "AABB",
            "coordinate_system": "world",
            "units": "meters",
            "total_objects": len(detection_annotations),
            "compatible_with": ["Group-Free-3D", "VoteNet", "ScanNet"],
        },
        "annotations": detection_annotations,
    }
    output_path = Path(output_path)
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(annotation_file, f, indent=2, ensure_ascii=False)
    print(f"[Annotation] Saved {len(detection_annotations)} annotations to: {output_path}")
    return detection_annotations


class _BBoxVisualizerBase:
    """Shared quality gates + plotting for both generators."""

    def __init__(self, results_root: str = "simulation_results", *, device=None):
        self.detection_classes = set(DETECTION_CLASSES)
        self.class_colors = dict(CLASS_COLORS)
        self.bbox_params = dict(DEFAULT_BBOX_PARAMS)
        self.results_root = Path(results_root)
        self.device = device_or_card(device)

    def remove_outliers(self, points, colors=None, k: int = 20, std_ratio: float = 2.0):
        """Statistical outlier removal (reference: :70-92), its k-NN on
        ``self.device``."""
        if len(points) < k:
            return points, colors
        mask, _ = remove_statistical_outliers(points, nb_neighbors=k, std_ratio=std_ratio,
                                              device=self.device)
        filtered_points = points[mask]
        filtered_colors = colors[mask] if colors is not None else None
        return filtered_points, filtered_colors

    def calculate_bbox(self, points: np.ndarray) -> Optional[Dict]:
        return calculate_bbox(points)

    def evaluate_bbox_quality(self, bbox: Dict, object_name: str):
        """Gates: class set, min points, min volume, max aspect
        (reference: :118-136)."""
        if object_name not in self.detection_classes:
            return False, f"Class {object_name} not in detection set"
        if bbox["point_count"] < self.bbox_params["min_points"]:
            return False, (
                f"Insufficient points: {bbox['point_count']} < "
                f"{self.bbox_params['min_points']}"
            )
        if bbox["volume"] < self.bbox_params["min_volume"]:
            return False, (
                f"Volume too small: {bbox['volume']:.6f} < "
                f"{self.bbox_params['min_volume']}"
            )
        if bbox["aspect_ratio"] > self.bbox_params["max_aspect_ratio"]:
            return False, (
                f"Aspect ratio too large: {bbox['aspect_ratio']:.2f} > "
                f"{self.bbox_params['max_aspect_ratio']}"
            )
        return True, "Quality OK"

    # ------------------------------------------------------------------
    def plot_bboxes_3d(self, bboxes: List[Dict], title: str, output_path: Path) -> Path:
        """3-D wireframe render of boxes (reference: :355-403)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
        for i, bbox in enumerate(bboxes):
            color = self.class_colors.get(bbox["object_name"], [0.5, 0.5, 0.5])
            self._draw_bbox_3d(ax, bbox, color)
            c = np.asarray(bbox["center"])
            ax.text(c[0], c[1], c[2], f"{bbox['object_name']}_{i + 1}", fontsize=8,
                    color=color)
        ax.set_xlabel("X (m)")
        ax.set_ylabel("Y (m)")
        ax.set_zlabel("Z (m)")
        ax.set_title(title)
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(output_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return output_path

    @staticmethod
    def _draw_bbox_3d(ax, bbox: Dict, color) -> None:
        center = np.asarray(bbox["center"])
        half = np.asarray(bbox["size"]) / 2
        signs = np.array(
            [
                [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
                [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1],
            ]
        )
        vertices = center + signs * half
        edges = [
            [0, 1], [1, 2], [2, 3], [3, 0],
            [4, 5], [5, 6], [6, 7], [7, 4],
            [0, 4], [1, 5], [2, 6], [3, 7],
        ]
        for edge in edges:
            pts = vertices[edge]
            ax.plot3D(pts[:, 0], pts[:, 1], pts[:, 2], color=color, linewidth=2,
                      alpha=0.8)

    def plot_bboxes_2d(
        self, bboxes: List[Dict], projection: str, title: str, output_path: Path
    ) -> Path:
        """2-D projection render (reference: :405-464)."""
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from matplotlib.patches import Rectangle

        axis_map = {"XY": (0, 1), "XZ": (0, 2), "YZ": (1, 2)}
        x_idx, y_idx = axis_map[projection]
        fig, ax = plt.subplots(figsize=(8, 6))
        for i, bbox in enumerate(bboxes):
            color = self.class_colors.get(bbox["object_name"], [0.5, 0.5, 0.5])
            lo = np.asarray(bbox["min_coords"])
            hi = np.asarray(bbox["max_coords"])
            ax.add_patch(
                Rectangle(
                    (lo[x_idx], lo[y_idx]),
                    hi[x_idx] - lo[x_idx],
                    hi[y_idx] - lo[y_idx],
                    fill=False,
                    color=color,
                    linewidth=2,
                    alpha=0.8,
                )
            )
            c = np.asarray(bbox["center"])
            ax.text(c[x_idx], c[y_idx], f"{bbox['object_name']}_{i + 1}",
                    fontsize=8, color=color)
        ax.set_xlabel(f"{projection[0]} (m)")
        ax.set_ylabel(f"{projection[1]} (m)")
        ax.set_title(f"{projection} Projection - {title}")
        ax.grid(True, alpha=0.3)
        ax.autoscale_view()
        output_path = Path(output_path)
        output_path.parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(output_path, dpi=150, bbox_inches="tight")
        plt.close(fig)
        return output_path


class S3DISBBoxVisualizer(_BBoxVisualizerBase):
    """Boxes from S3DIS annotation txt files (reference: s3dis_bbox_visualizer.py)."""

    def load_annotation_file(self, annotation_file: Path) -> Optional[Dict]:
        """Per-instance txt: [x y z r g b (label)] rows (reference: :44-68)."""
        annotation_file = Path(annotation_file)
        try:
            data = np.loadtxt(annotation_file, ndmin=2)
            if len(data) == 0:
                return None
            points = data[:, :3]
            colors = data[:, 3:6] / 255.0 if data.shape[1] >= 6 else None
            labels = data[:, 6].astype(int) if data.shape[1] > 6 else None
            return {
                "points": points,
                "colors": colors,
                "labels": labels,
                "object_name": annotation_file.stem.split("_")[0],
                "file_name": annotation_file.name,
            }
        except Exception:
            return None

    def load_room_point_cloud(self, room_path: Path) -> Optional[Dict]:
        """Whole-room txt cloud (reference: :155-182)."""
        room_path = Path(room_path)
        room_files = sorted(room_path.glob("*.txt"))
        if not room_files:
            return None
        try:
            data = np.loadtxt(room_files[0], ndmin=2)
            if len(data) == 0:
                return None
            return {
                "points": data[:, :3],
                "colors": data[:, 3:6] / 255.0 if data.shape[1] >= 6 else None,
                "labels": data[:, 6].astype(int) if data.shape[1] > 6 else None,
                "file_name": room_files[0].name,
            }
        except Exception:
            return None

    def visualize_room_bboxes(
        self, room_path: Path, output_dir: Optional[Path] = None
    ) -> Optional[List[Dict]]:
        """Per-room pipeline -> JSON into results_root/<scene>/
        (reference: :184-250)."""
        room_path = Path(room_path)
        annotations_dir = room_path / "Annotations"
        if not annotations_dir.exists():
            return None
        bboxes = []
        for txt_file in sorted(annotations_dir.glob("*.txt")):
            data = self.load_annotation_file(txt_file)
            if data is None:
                continue
            object_name = data["object_name"]
            if object_name not in self.detection_classes:
                continue
            filtered_points, _ = self.remove_outliers(data["points"], data["colors"])
            if len(filtered_points) == 0:
                continue
            bbox_info = self.calculate_bbox(filtered_points)
            if bbox_info is None:
                continue
            is_suitable, _ = self.evaluate_bbox_quality(bbox_info, object_name)
            if not is_suitable:
                continue
            bbox_info["object_name"] = object_name
            bbox_info["file_name"] = data["file_name"]
            bbox_info["room_name"] = room_path.name
            bboxes.append(bbox_info)

        if not bboxes:
            return None

        area_name = room_path.parent.name
        scene_name = f"{area_name}_{room_path.name}"
        scene_dir = self.results_root / scene_name
        scene_dir.mkdir(parents=True, exist_ok=True)
        json_path = scene_dir / f"{scene_name}_detection_annotations.json"
        generate_detection_annotations(bboxes, json_path, dataset="S3DIS")
        return bboxes

    def process_area(self, area_path: Path, output_dir: Optional[Path] = None
                     ) -> Optional[List[Dict]]:
        """All rooms of an area (reference: :252-302)."""
        area_path = Path(area_path)
        if not area_path.exists():
            return None
        all_room_bboxes: List[Dict] = []
        for room in sorted(d for d in area_path.iterdir() if d.is_dir()):
            room_bboxes = self.visualize_room_bboxes(room, None)
            if room_bboxes:
                all_room_bboxes.extend(room_bboxes)
        return all_room_bboxes

    def generate_detection_annotations(self, bboxes, output_path):
        return generate_detection_annotations(bboxes, output_path, dataset="S3DIS")


class LiDARNetBBoxVisualizer(_BBoxVisualizerBase):
    """Boxes from labeled PLYs (reference: lidar_net_bbox_visualizer.py)."""

    def __init__(self, results_root: str = "simulation_results", *, device=None):
        super().__init__(results_root, device=device)
        self.semantic_mapping = dict(LIDAR_NET_SEMANTIC_MAPPING)

    def load_ply_file(self, ply_path: Path) -> Optional[Dict]:
        """Labeled PLY -> arrays (reference reader loop: :55-161, replaced by
        the vectorized codec)."""
        ply_path = Path(ply_path)
        try:
            points, colors, sem, ins = read_labeled_ply(ply_path)
            if len(points) == 0:
                return None
            return {
                "points": points.astype(np.float64),
                "colors": colors.astype(np.float64) / 255.0,
                "semantic_labels": sem,
                "instance_labels": ins,
                "file_name": ply_path.name,
            }
        except Exception as e:
            print(f"[Error] Failed to load PLY {ply_path}: {e}")
            return None

    def extract_instances_by_semantic(
        self, room_data: Dict, target_semantic_id: int
    ) -> List[Dict]:
        """Split one semantic class into instances (reference: :163-201)."""
        points = room_data["points"]
        colors = room_data["colors"]
        semantic_labels = room_data["semantic_labels"]
        instance_labels = room_data["instance_labels"]
        semantic_mask = semantic_labels == target_semantic_id
        if not np.any(semantic_mask):
            return []
        target_points = points[semantic_mask]
        target_colors = colors[semantic_mask] if colors is not None else None
        target_instances = instance_labels[semantic_mask]
        instances = []
        for instance_id in np.unique(target_instances):
            if instance_id == 0:  # unlabeled
                continue
            m = target_instances == instance_id
            if np.sum(m) < self.bbox_params["min_points"]:
                continue
            instances.append(
                {
                    "points": target_points[m],
                    "colors": target_colors[m] if target_colors is not None else None,
                    "instance_id": int(instance_id),
                    "semantic_id": int(target_semantic_id),
                }
            )
        return instances

    def evaluate_bbox_quality(self, bbox: Dict, object_name: str):
        """LiDAR-Net variant skips the class-set gate (reference: :251-259)."""
        if bbox["volume"] < self.bbox_params["min_volume"]:
            return False, f"Volume too small: {bbox['volume']:.6f}"
        if bbox["aspect_ratio"] > self.bbox_params["max_aspect_ratio"]:
            return False, f"Aspect ratio too large: {bbox['aspect_ratio']:.2f}"
        return True, "Quality check passed."

    def process_room_instances(
        self, room_ply_path: Path, output_dir: Optional[Path] = None
    ) -> Optional[List[Dict]]:
        """Full per-room flow -> JSON + PLY copy (reference: :261-356)."""
        room_ply_path = Path(room_ply_path)
        if not room_ply_path.exists():
            print(f"[Error] Room file does not exist: {room_ply_path}")
            return None
        room_data = self.load_ply_file(room_ply_path)
        if room_data is None:
            return None
        all_bboxes = []
        for class_name, semantic_id in self.semantic_mapping.items():
            for instance in self.extract_instances_by_semantic(room_data, semantic_id):
                filtered_points, filtered_colors = self.remove_outliers(
                    instance["points"], instance["colors"]
                )
                if len(filtered_points) == 0:
                    continue
                bbox_info = self.calculate_bbox(filtered_points)
                if bbox_info is None:
                    continue
                is_suitable, _ = self.evaluate_bbox_quality(bbox_info, class_name)
                if not is_suitable:
                    continue
                bbox_info["object_name"] = class_name
                bbox_info["instance_id"] = instance["instance_id"]
                bbox_info["semantic_id"] = instance["semantic_id"]
                all_bboxes.append(bbox_info)
        if not all_bboxes:
            return None

        scene_name = room_ply_path.stem
        scene_dir = self.results_root / scene_name
        scene_dir.mkdir(parents=True, exist_ok=True)
        json_path = scene_dir / f"{scene_name}_detection_annotations.json"
        generate_detection_annotations(all_bboxes, json_path, dataset="LiDAR-Net")
        try:
            import shutil

            target = scene_dir / room_ply_path.name
            if not target.exists():
                shutil.copy2(room_ply_path, target)
        except Exception as e:
            print(f"[Warning] Failed to copy PLY file: {e}")
        return all_bboxes

    def process_area(self, area_path: Path, output_dir: Optional[Path] = None
                     ) -> List[Dict]:
        """All labeled PLYs under a directory (reference: :427-488)."""
        area_path = Path(area_path)
        all_bboxes: List[Dict] = []
        for ply in sorted(area_path.glob("*.ply")):
            bboxes = self.process_room_instances(ply, output_dir)
            if bboxes:
                all_bboxes.extend(bboxes)
        return all_bboxes

    def generate_detection_annotations(self, bboxes, output_path):
        return generate_detection_annotations(bboxes, output_path, dataset="LiDAR-Net")
