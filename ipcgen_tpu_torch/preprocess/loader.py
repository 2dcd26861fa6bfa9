"""S3DIS data loading and the preprocessing stage.

Port of ``ipcgen_tpu/preprocess/loader.py``: the room loader, the
preprocessor (statistical outlier removal and k-NN PCA normals on the
device through ``ops/outliers.py`` and ``ops/normals.py``; robot sparsity
and occlusion in numpy with the same seeded ``default_rng``, copied as they
are) and ``preprocess_room`` with its spans and pickle schema.  Every entry
point takes a keyword-only ``device``; None means the card.
"""

from __future__ import annotations

import pickle
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ipcgen_tpu_torch.ops.normals import estimate_normals
from ipcgen_tpu_torch.ops.outliers import (
    remove_outliers_and_estimate_normals,
    remove_statistical_outliers,
)
from ipcgen_tpu_torch.utils import native


class S3DISLoader:
    """Loader for the S3DIS dataset (reference: s3dis_data_loader.py:18-74)."""

    def __init__(self, data_root: str):
        self.data_root = Path(data_root)
        self.area_names = [f"Area_{i}" for i in range(1, 7)]

    def load_room_data(self, area_name: str, room_name: str):
        """Room txt 'x y z r g b [label]' -> (points, colors, labels)
        (reference: :25-66)."""
        room_path = self.data_root / area_name / room_name
        if not room_path.exists():
            raise FileNotFoundError(f"Room data not found: {room_path}")
        txt_files = sorted(room_path.glob("*.txt"))
        if txt_files:
            data = native.parse_float_table(str(txt_files[0]))
            if data is None:
                data = np.loadtxt(txt_files[0], ndmin=2)
        else:
            npy_file = room_path / "points.npy"
            if not npy_file.exists():
                raise FileNotFoundError(f"Point cloud data missing: {room_path}")
            data = np.load(npy_file)
        points = data[:, :3]
        colors = data[:, 3:6] / 255.0 if data.shape[1] >= 6 else np.ones((len(data), 3))
        labels = data[:, 6].astype(int) if data.shape[1] > 6 else None
        return points, colors, labels

    def get_available_rooms(self, area_name: str) -> List[str]:
        area_path = self.data_root / area_name
        if not area_path.exists():
            return []
        return sorted(d.name for d in area_path.iterdir() if d.is_dir())


DEFAULT_PREPROCESSING = {
    "estimate_normals": True,
    "use_shs_net": False,
    "normal_search_radius": 0.1,
    "normal_max_nn": 30,
    "remove_outliers": True,
    "outlier_nb_neighbors": 20,
    "outlier_std_ratio": 2.0,
}


class S3DISPreprocessor:
    """Configurable preprocessing pipeline (reference: :77-221) on
    ``device`` (None: the card)."""

    def __init__(self, config_dict: Dict, seed: Optional[int] = None, *, device=None):
        cfg = dict(DEFAULT_PREPROCESSING)
        cfg.update(config_dict.get("preprocessing", {}))
        self.config = cfg
        self.rng = np.random.default_rng(seed)
        self.device = device

    def preprocess_pointcloud(self, points, colors=None, labels=None):
        """Outlier removal + normal estimation (reference: :85-158).

        Returns (points, colors, labels, normals).
        """
        points = np.asarray(points)
        if self.config["remove_outliers"] and self.config["estimate_normals"]:
            # One grid self-join serves the outlier means and the PCA
            # neighbourhoods (the same inlier mask as the separate path).
            mask, normals = remove_outliers_and_estimate_normals(
                points,
                nb_neighbors=self.config["outlier_nb_neighbors"],
                std_ratio=self.config["outlier_std_ratio"],
                radius=self.config["normal_search_radius"],
                max_nn=self.config["normal_max_nn"],
                device=self.device,
            )
            points = points[mask]
            if colors is not None:
                colors = np.asarray(colors)[mask]
            if labels is not None:
                labels = np.asarray(labels)[mask]
            return points, colors, labels, normals
        if self.config["remove_outliers"]:
            mask, _ = remove_statistical_outliers(
                points,
                nb_neighbors=self.config["outlier_nb_neighbors"],
                std_ratio=self.config["outlier_std_ratio"],
                device=self.device,
            )
            points = points[mask]
            if colors is not None:
                colors = np.asarray(colors)[mask]
            if labels is not None:
                labels = np.asarray(labels)[mask]

        normals = None
        if self.config["estimate_normals"]:
            # The reference can route through SHS-Net, a module absent from
            # its repo (s3dis_data_loader.py:117-144); PCA is what runs.
            normals = estimate_normals(
                points,
                radius=self.config["normal_search_radius"],
                max_nn=self.config["normal_max_nn"],
                device=self.device,
            )
        return points, colors, labels, normals

    def simulate_robot_sparsity(
        self, points, colors=None, labels=None, sparsity_config: Optional[Dict] = None
    ):
        """Random keep-ratio subsample + optional occlusion (reference: :160-180)."""
        if sparsity_config is None:
            return points, colors, labels
        if sparsity_config["keep_ratio"] < 1.0:
            n_keep = int(len(points) * sparsity_config["keep_ratio"])
            indices = self.rng.choice(len(points), n_keep, replace=False)
            points = points[indices]
            if colors is not None:
                colors = colors[indices]
            if labels is not None:
                labels = labels[indices]
        if sparsity_config.get("occlusion", False):
            points, colors, labels = self._simulate_occlusion(points, colors, labels)
        return points, colors, labels

    def _simulate_occlusion(
        self, points, colors=None, labels=None, occlusion_ratio: float = 0.3
    ):
        """Robot-centric occlusion heuristic (reference: :182-221): robot at
        room center 0.5 m above floor, +-30 deg vertical FOV, 8 m range,
        random corner dropout."""
        points = np.asarray(points)
        min_coords = points.min(axis=0)
        max_coords = points.max(axis=0)
        room_size = max_coords - min_coords
        robot_pos = np.array(
            [
                (min_coords[0] + max_coords[0]) / 2,
                (min_coords[1] + max_coords[1]) / 2,
                min_coords[2] + 0.5,
            ]
        )
        rel = points - robot_pos
        distances = np.linalg.norm(rel, axis=1)
        elevation = np.arctan2(rel[:, 2], np.sqrt(rel[:, 0] ** 2 + rel[:, 1] ** 2))
        vertical_fov_mask = np.abs(elevation) < np.radians(30)
        distance_mask = distances < 8.0
        corner_mask = np.ones(len(points), dtype=bool)
        for i in (0, 1):
            for corner_region in (
                points[:, i] < min_coords[i] + room_size[i] * 0.1,
                points[:, i] > max_coords[i] - room_size[i] * 0.1,
            ):
                corner_mask[corner_region] &= (
                    self.rng.random(int(np.sum(corner_region))) > 0.6
                )
        final_mask = vertical_fov_mask & distance_mask & corner_mask
        return (
            points[final_mask],
            colors[final_mask] if colors is not None else None,
            labels[final_mask] if labels is not None else None,
        )


def preprocess_room(
    data_root: str,
    area_name: str,
    room_name: str,
    config: Dict,
    output_dir: Optional[str] = None,
    sparsity_experiments: Optional[List[Dict]] = None,
    seed: Optional[int] = None,
    *,
    device=None,
) -> Dict:
    """Full per-room preprocessing -> pickle payload, on ``device`` (None:
    the card) (reference main loop: s3dis_data_loader.py:733-951, pickle
    schema :648-656).

    A sparse variant whose point count changed gets its normals estimated
    again (reference: :861-908).  ``spans`` holds the seconds of ``load``,
    ``outliers_normals``, ``variants`` and, with ``output_dir``, ``pickle``.
    """
    loader = S3DISLoader(data_root)
    preproc = S3DISPreprocessor(config, seed=seed, device=device)
    spans: Dict[str, float] = {}
    t0 = time.time()
    ts = time.time()
    points, colors, labels = loader.load_room_data(area_name, room_name)
    spans["load"] = time.time() - ts
    ts = time.time()
    points, colors, labels, normals = preproc.preprocess_pointcloud(
        points, colors, labels
    )
    spans["outliers_normals"] = time.time() - ts
    ts = time.time()

    room_data: Dict = {
        "area": area_name,
        "room": room_name,
        "points": points,
        "colors": colors,
        "labels": labels,
        "normals": normals,
        "variants": {},
        "preprocess_time": None,
    }

    for sp_cfg in sparsity_experiments or [
        {"name": "dense", "keep_ratio": 1.0, "occlusion": False}
    ]:
        sp_points, sp_colors, sp_labels = preproc.simulate_robot_sparsity(
            points, colors, labels, sp_cfg
        )
        if len(sp_points) != len(points):
            sp_normals = estimate_normals(
                sp_points,
                radius=preproc.config["normal_search_radius"],
                max_nn=preproc.config["normal_max_nn"],
                device=device,
            )
        else:
            sp_normals = normals
        room_data["variants"][sp_cfg["name"]] = {
            "points": sp_points,
            "colors": sp_colors,
            "labels": sp_labels,
            "normals": sp_normals,
            "config": sp_cfg,
        }

    spans["variants"] = time.time() - ts
    room_data["preprocess_time"] = time.time() - t0
    room_data["spans"] = {k: round(v, 3) for k, v in spans.items()}
    if output_dir is not None:
        ts = time.time()
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        pkl = out / f"{area_name}_{room_name}_preprocessed.pkl"
        with open(pkl, "wb") as f:
            pickle.dump(room_data, f)
        room_data["output_path"] = str(pkl)
        room_data["spans"]["pickle"] = round(time.time() - ts, 3)
    return room_data


def load_preprocessed_data(data_path: str) -> Dict:
    """Load a preprocessed room pickle (reference: s3dis_nksr_reconstructor.py:345-349)."""
    with open(data_path, "rb") as f:
        return pickle.load(f)
