"""Simulation scene container, statistics and exporters, with the port's
label path.

Copy of ``ipcgen_tpu/containers/sim_scene.py`` (same artifacts:
simulation_statistics.{json,txt}, simulation_summary, combined_pointcloud.ply
and the byte-identical combined_pointcloud_with_label.ply), with every method
that reached JAX or matplotlib replaced:

- ``load_room_label_data`` and ``LabelPrefetch`` call the port's exact 1-NN
  and build the port's ``LabelGrid`` on the scene's device;
- the 1-NN label transfer runs on a worker thread over the scan's
  device-resident points;
- the per-frame colours of ``combined_pointcloud.ply`` come from a copied
  viridis table.

The JAX package swallows every exception on the label path and falls back to
default labels.  Here the boundary is the data, not the exception: a scene
without annotation data gets default labels, as in the JAX package (no data
root, area or room; a room with no ``Annotations/`` directory, which prints a
warning; or a room with no annotation rows), and a room with no raw cloud
gets grey colours with its annotation labels (also with a warning).  A file
that exists but cannot be read, and any failure of the port's own compute
(the grid, the 1-NN, a kernel), propagates: it can never turn into a labeled
PLY full of default labels.  A batch run can
start a room's prefetch ahead of its sim stage (``prewarm_labels``); the
simulator's ``load_scene`` claims it (``claim_prewarmed_labels``).
"""

from __future__ import annotations

import json
import os
import pickle
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ipcgen_tpu_torch.containers.sim_frame import S3DISSimFrame
from ipcgen_tpu_torch.io.ply import read_point_cloud, write_labeled_ply, write_point_cloud
from ipcgen_tpu_torch.ops.grid_nn import LabelGrid
from ipcgen_tpu_torch.ops.knn import nearest_neighbor_indices
from ipcgen_tpu_torch.semantic.annotations import S3DISAnnotationLoader, S3DISColorEncoder
from ipcgen_tpu_torch.utils import native
from ipcgen_tpu_torch.utils.device import device_or_card
from ipcgen_tpu_torch.utils.json_utils import NumpyEncoder
from ipcgen_tpu_torch.utils.viridis import viridis_rgb


def _exact_coord_join(queries: np.ndarray, refs: np.ndarray):
    """Row-exact coordinate join: for each query row, the index of an
    identical (to 0.1 mm) row in ``refs``.

    S3DIS ``Annotations/*.txt`` files are row subsets of the room cloud, so
    the annotation -> raw colour match (a BallTree 1-NN in the reference,
    s3dis_sim_scene.py:536-539) resolves by exact lookup for essentially
    every point; only genuinely unmatched rows pay the NN.

    Returns (idx (N,) int64 into refs, matched (N,) bool).
    """
    if len(refs) == 0 or len(queries) == 0:
        return (
            np.zeros(len(queries), np.int64),
            np.zeros(len(queries), bool),
        )
    q = np.round(np.asarray(queries, np.float64) * 1e4).astype(np.int64)
    r = np.round(np.asarray(refs, np.float64) * 1e4).astype(np.int64)
    p1, p2, p3 = np.int64(73856093), np.int64(19349663), np.int64(83492791)
    qh = (q[:, 0] * p1) ^ (q[:, 1] * p2) ^ (q[:, 2] * p3)
    rh = (r[:, 0] * p1) ^ (r[:, 1] * p2) ^ (r[:, 2] * p3)
    order = np.argsort(rh, kind="stable")
    rh_sorted = rh[order]
    pos = np.minimum(np.searchsorted(rh_sorted, qh), len(rh_sorted) - 1)
    cand = order[pos]
    # Verify coordinates, not just the hash: a collision whose first
    # sorted slot holds different coordinates simply falls back to the NN.
    matched = (rh_sorted[pos] == qh) & np.all(r[cand] == q, axis=1)
    return cand, matched


def _load_room_txt_pointcloud(file_path: str):
    """S3DIS txt: 'x y z r g b [label]' rows (reference: :483-503)."""
    data = native.parse_float_table(file_path)
    if data is None:
        data = np.loadtxt(file_path)
    if data.ndim != 2 or data.shape[1] < 6:
        return None, None
    points = data[:, :3]
    colors = data[:, 3:6]
    if colors.max() > 1.0:
        colors = colors / 255.0
    return points, colors


def _load_room_original_data(s3dis_data_root, area, room):
    """Load the raw TLS cloud (xyz + rgb) for colour lookup (reference:
    :429-481).  (None, None) when the room has no raw cloud; a file that
    fails to parse raises."""
    if not s3dis_data_root or not area or not room:
        return None, None
    base = f"{s3dis_data_root}/{area}/{room}"
    candidates = [
        f"{base}/{room}.txt",
        f"{base}/pointcloud.ply",
        f"{base}/Area_{area}_{room}.ply",
        f"{base}/Area_{area}_{room}_inst_nostring.ply",
        f"{base}/Area_{area}_{room}_inst_nostring.txt",
    ]
    path = next((p for p in candidates if os.path.exists(p)), None)
    if path is None:
        return None, None
    if path.endswith(".txt"):
        points, colors = _load_room_txt_pointcloud(path)
    else:
        points, colors, _ = read_point_cloud(path)
    if points is None or len(points) == 0:
        return None, None
    if colors is None:
        colors = np.ones((len(points), 3), dtype=np.float32) * 0.5
    return points, colors


def _host_nn_small(queries: np.ndarray, refs: np.ndarray) -> np.ndarray:
    """Chunked numpy brute-force 1-NN for SMALL query sets.

    Used by the background label prefetch so its rare unmatched-row
    fallback never dispatches device work concurrently with the scan it is
    meant to hide behind."""
    out = np.empty(len(queries), np.int64)
    r = np.asarray(refs, np.float32)
    for s in range(0, len(queries), 256):
        q = np.asarray(queries[s : s + 256], np.float32)
        d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
        out[s : s + 256] = np.argmin(d2, axis=1)
    return out


def load_room_label_data(s3dis_data_root, area, room, host_only_nn=False,
                         spans=None, device="cuda"):
    """Annotation cloud + exact-join colour match against the raw cloud.

    Returns (points, colors, sem, ins), or four Nones when the scene has no
    annotation data.  Unmatched annotation rows take the colour of their
    nearest raw point (host brute force for a small remainder when
    ``host_only_nn``, else the exact 1-NN on ``device``).
    """
    if spans is None:
        spans = {}
    if not s3dis_data_root or not area or not room:
        return None, None, None, None
    ann_dir = os.path.join(s3dis_data_root, area, room, "Annotations")
    if not os.path.isdir(ann_dir):
        print(f"[Labels] warning: {ann_dir} does not exist; {area}/{room} gets default "
              "colours and labels", flush=True)
        return None, None, None, None
    loader = S3DISAnnotationLoader(s3dis_data_root, verbose=False)
    t0 = time.time()
    room_annotations = loader.load_room_annotations(area, room)
    spans["ann_parse"] = time.time() - t0
    if not room_annotations:
        return None, None, None, None
    t0 = time.time()
    points, semantic_labels, instance_labels = (
        loader.create_labeled_pointcloud_with_instances(room_annotations)
    )
    spans["ann_stack"] = time.time() - t0
    if len(points) == 0:
        return None, None, None, None
    t0 = time.time()
    original_points, original_colors = _load_room_original_data(
        s3dis_data_root, area, room
    )
    spans["raw_parse"] = time.time() - t0
    if original_points is None or original_colors is None:
        print(f"[Labels] warning: {area}/{room} has no raw cloud; its annotation points "
              "get grey colours", flush=True)
        colors = np.ones((len(points), 3), dtype=np.float32) * 0.5
    else:
        oc = np.asarray(original_colors)
        idx_exact, matched = _exact_coord_join(points, original_points)
        if matched.all():
            colors = oc[idx_exact]
        else:
            colors = np.empty((len(points), oc.shape[1]), oc.dtype)
            colors[matched] = oc[idx_exact[matched]]
            refs = np.asarray(original_points, dtype=np.float32)
            unmatched = np.asarray(points[~matched], dtype=np.float32)
            if host_only_nn and len(unmatched) <= 4096:
                idx = _host_nn_small(unmatched, refs)
            else:
                idx = nearest_neighbor_indices(unmatched, refs, device=device)
            colors[~matched] = oc[idx]
    return points, colors, semantic_labels, instance_labels


class LabelPrefetch:
    """Background load of a room's label data and its ``LabelGrid``.

    Started when the scene loads, so the annotation parse and the grid build
    hide behind trajectory planning and the scan.  An exception in the
    worker is re-raised by ``join``.
    """

    def __init__(self, s3dis_data_root, area, room, device="cuda"):
        self.seconds = 0.0
        self.spans: dict = {}
        self.grid: Optional[LabelGrid] = None
        self._data = (None, None, None, None)
        self._error: Optional[BaseException] = None
        self._thread = threading.Thread(
            target=self._work, args=(s3dis_data_root, area, room, device),
            daemon=True,
        )
        self._thread.start()

    def _work(self, s3dis_data_root, area, room, device):
        t0 = time.time()
        try:
            self._data = load_room_label_data(
                s3dis_data_root, area, room, host_only_nn=True,
                spans=self.spans, device=device,
            )
            if self._data[0] is not None and len(self._data[0]):
                tg = time.time()
                self.grid = LabelGrid(np.asarray(self._data[0], np.float32),
                                      device=device)
                self.spans["grid_build"] = time.time() - tg
        except Exception as e:  # handed to join(), which re-raises it
            self._error = e
        finally:
            self.seconds = time.time() - t0

    def join(self):
        """Block until loaded; returns (points, colors, sem, ins)."""
        self._thread.join()
        if self._error is not None:
            raise self._error
        return self._data


_prewarm_registry: Dict[Tuple[str, str, str, str], LabelPrefetch] = {}


def _prewarm_key(s3dis_data_root, area, room, device):
    device = device_or_card(device)
    return (str(s3dis_data_root), str(area), str(room), str(device)), device


def prewarm_labels(s3dis_data_root, area, room, *, device=None) -> Optional[LabelPrefetch]:
    """Start a room's label prefetch on ``device`` (None: the card) ahead of
    its sim stage, so the annotation parse, colour join and grid build hide
    behind earlier work (the recon stage, or the previous room).
    ``S3DISSimulator.load_scene`` claims it; a room prewarmed again before
    it is claimed keeps its first prefetch.  None without a root, area or
    room."""
    if not s3dis_data_root or not area or not room:
        return None
    key, device = _prewarm_key(s3dis_data_root, area, room, device)
    pf = _prewarm_registry.get(key)
    if pf is None:
        pf = LabelPrefetch(s3dis_data_root, area, room, device=device)
        _prewarm_registry[key] = pf
    return pf


def claim_prewarmed_labels(s3dis_data_root, area, room, *, device=None):
    """Pop the prefetch prewarmed for this room on ``device`` (None: the
    card), or None when there is none."""
    return _prewarm_registry.pop(_prewarm_key(s3dis_data_root, area, room, device)[0],
                                 None)


@dataclass
class SimulationStats:
    """Aggregate simulation statistics (reference: s3dis_sim_scene.py:29-55)."""

    total_frames: int
    total_points: int
    average_coverage: float
    average_scan_density: float
    average_incident_angle: float
    average_range: float
    simulation_time: float
    frames_per_second: float

    def to_dict(self) -> Dict[str, Any]:
        return {
            "total_frames": self.total_frames,
            "total_points": self.total_points,
            "average_coverage": self.average_coverage,
            "average_scan_density": self.average_scan_density,
            "average_incident_angle": self.average_incident_angle,
            "average_range": self.average_range,
            "simulation_time": self.simulation_time,
            "frames_per_second": self.frames_per_second,
        }


class ResultExporter:
    """Multi-format result exporter (reference: s3dis_sim_scene.py:58-125)."""

    def __init__(self, output_dir: Path):
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def export_frames(self, frames: List[S3DISSimFrame], format: str = "pkl") -> None:
        frames_dir = self.output_dir / "frames"
        frames_dir.mkdir(exist_ok=True)
        for frame in frames:
            if format == "pkl":
                with open(frames_dir / f"frame_{frame.frame_index:04d}.pkl", "wb") as f:
                    pickle.dump(frame.to_dict(), f)
            elif format == "json":
                with open(frames_dir / f"frame_{frame.frame_index:04d}.json", "w") as f:
                    json.dump(frame.to_dict(), f, indent=2, cls=NumpyEncoder)
            else:
                raise ValueError(f"Unsupported format: {format}")

    def export_statistics(self, stats: SimulationStats, format: str = "json") -> None:
        if format == "json":
            with open(self.output_dir / "simulation_statistics.json", "w") as f:
                json.dump(stats.to_dict(), f, indent=2, cls=NumpyEncoder)
        elif format == "txt":
            # Text layout matches the reference byte-for-byte
            # (s3dis_sim_scene.py:92-103) so resume/skip logic and downstream
            # parsers keep working.
            with open(self.output_dir / "simulation_statistics.txt", "w") as f:
                f.write("Simulation Statistics\n")
                f.write("=" * 50 + "\n")
                f.write(f"Total frames: {stats.total_frames}\n")
                f.write(f"Total points: {stats.total_points}\n")
                f.write(f"Average coverage: {stats.average_coverage:.3f}\n")
                f.write(f"Average scan density: {stats.average_scan_density:.3f}\n")
                f.write(f"Average incident angle: {stats.average_incident_angle:.3f}\n")
                f.write(f"Average range: {stats.average_range:.3f}\n")
                f.write(f"Simulation time: {stats.simulation_time:.3f}s\n")
                f.write(f"Frames per second: {stats.frames_per_second:.3f} FPS\n")
        else:
            raise ValueError(f"Unsupported format: {format}")

    def export_summary(self, sim_scene: "S3DISSimScene", format: str = "json") -> None:
        summary = {
            "scene_name": sim_scene.scene_name,
            "simulation_config": sim_scene.simulation_config,
            "statistics": sim_scene.statistics.to_dict() if sim_scene.statistics else None,
            "frame_summary": {
                "frame_indices": [f.frame_index for f in sim_scene.frames],
                "point_counts": [f.get_num_points() for f in sim_scene.frames],
                "coverage_ratios": [f.get_coverage_ratio() for f in sim_scene.frames],
            },
        }
        if format == "json":
            with open(self.output_dir / "simulation_summary.json", "w") as f:
                json.dump(summary, f, indent=2, cls=NumpyEncoder)
        else:
            raise ValueError(f"Unsupported format: {format}")


class S3DISSimScene:
    """All frames of one simulated room, its exporters and the port's label
    transfer (reference: s3dis_sim_scene.py:128-699)."""

    def __init__(
        self,
        scene_name: str,
        simulation_config: Optional[Dict[str, Any]] = None,
        mesh: Optional[object] = None,
        s3dis_data_root: Optional[str] = None,
        area: Optional[str] = None,
        room: Optional[str] = None,
        label_prefetch: Optional[LabelPrefetch] = None,
        device="cuda",
    ):
        self.scene_name = scene_name
        self.simulation_config = simulation_config or {}
        self.frames: List[S3DISSimFrame] = []
        self.statistics: Optional[SimulationStats] = None
        self.exporter: Optional[ResultExporter] = None
        self.mesh = mesh
        self.s3dis_data_root = s3dis_data_root
        self.area = area
        self.room = room
        self.device = device
        self._s3dis_cache: Optional[Dict[str, Any]] = None
        self._label_lock = threading.Lock()
        self._transfer_error: Optional[BaseException] = None
        self.label_prefetch = label_prefetch
        # Wall-clock sub-spans (scan/d2h/label/export), filled by the
        # simulator and by save_results below.
        self.profile: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def append_frame(self, frame: S3DISSimFrame) -> None:
        self.frames.append(frame)

    def get_total_frames(self) -> int:
        return len(self.frames)

    def get_total_points(self) -> int:
        return sum(f.get_num_points() for f in self.frames)

    def get_average_coverage(self) -> float:
        if not self.frames:
            return 0.0
        return float(np.mean([f.get_coverage_ratio() for f in self.frames]))

    def get_average_scan_density(self) -> float:
        if not self.frames:
            return 0.0
        return float(np.mean([f.get_scan_density() for f in self.frames]))

    def get_average_incident_angle(self) -> float:
        if not self.frames:
            return 0.0
        return float(np.mean([f.get_mean_incident_angle() for f in self.frames]))

    def get_average_range(self) -> float:
        if not self.frames:
            return 0.0
        return float(np.mean([f.get_mean_range() for f in self.frames]))

    def get_frame_statistics(self) -> Dict[str, List[float]]:
        if not self.frames:
            return {}
        return {
            "frame_indices": [f.frame_index for f in self.frames],
            "point_counts": [f.get_num_points() for f in self.frames],
            "coverage_ratios": [f.get_coverage_ratio() for f in self.frames],
            "scan_densities": [f.get_scan_density() for f in self.frames],
            "incident_angles": [f.get_mean_incident_angle() for f in self.frames],
            "ranges": [f.get_mean_range() for f in self.frames],
        }

    def get_quality_distribution(self) -> Dict[str, Any]:
        if not self.frames:
            return {}
        fs = self.get_frame_statistics()

        def dist(vals):
            return {
                "mean": float(np.mean(vals)),
                "std": float(np.std(vals)),
                "min": float(np.min(vals)),
                "max": float(np.max(vals)),
            }

        return {
            "coverage_distribution": dist(fs["coverage_ratios"]),
            "point_count_distribution": dist(fs["point_counts"]),
            "incident_angle_distribution": dist(fs["incident_angles"]),
        }

    def compute_statistics(self, simulation_time: float = 0.0) -> None:
        if not self.frames:
            self.statistics = SimulationStats(0, 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
            return
        self.statistics = SimulationStats(
            total_frames=self.get_total_frames(),
            total_points=self.get_total_points(),
            average_coverage=self.get_average_coverage(),
            average_scan_density=self.get_average_scan_density(),
            average_incident_angle=self.get_average_incident_angle(),
            average_range=self.get_average_range(),
            simulation_time=simulation_time,
            frames_per_second=(
                self.get_total_frames() / simulation_time if simulation_time > 0 else 0.0
            ),
        )

    # ------------------------------------------------------------------
    def save_results(self, output_dir: Path, formats: List[str] = ["pkl", "txt"]) -> None:
        """Write all result artifacts (reference: s3dis_sim_scene.py:249-276).

        Preserves the reference's quirk of recomputing statistics without a
        wall time unless compute_statistics(t) was already called.
        """
        output_dir = Path(output_dir)
        self.exporter = ResultExporter(output_dir)
        if self.statistics is None:
            self.compute_statistics()

        t0 = time.time()
        for fmt in formats:
            if fmt in ("json", "txt"):
                self.exporter.export_statistics(self.statistics, fmt)
        if "json" in formats:
            self.exporter.export_summary(self, "json")
        elif "txt" in formats:
            self._save_simple_summary(output_dir)
        self.profile["export_stats"] = time.time() - t0

        t0 = time.time()
        self._export_combined_pointcloud(output_dir)
        self.profile["export_ply_viridis"] = time.time() - t0
        self._export_combined_pointcloud_with_labels(output_dir)

    def _save_simple_summary(self, output_dir: Path) -> None:
        summary_path = output_dir / "simulation_summary.txt"
        with open(summary_path, "w", encoding="utf-8") as f:
            f.write("S3DIS Simulation Results Summary\n")
            f.write("=" * 50 + "\n\n")
            f.write(f"Scene name: {self.scene_name}\n")
            f.write(f"Total frames: {len(self.frames)}\n")
            f.write(f"Total points: {self.get_total_points():,}\n")
            f.write(f"Average coverage: {self.get_average_coverage():.3f}\n")
            f.write(f"Average scan density: {self.get_average_scan_density():.3f}\n")
            f.write(f"Average incident angle: {self.get_average_incident_angle():.1f}°\n")
            f.write(f"Average range: {self.get_average_range():.2f}m\n")
            if self.statistics:
                f.write("\nSimulation Statistics:\n")
                f.write(f"  Simulation time: {self.statistics.simulation_time:.2f}s\n")
                f.write(f"  Frame rate: {self.statistics.frames_per_second:.1f} FPS\n")
            f.write("\nFrame Details:\n")
            f.write("-" * 30 + "\n")
            for i, frame in enumerate(self.frames):
                f.write(
                    f"Frame {i + 1:2d}: {frame.get_num_points():5d} points, "
                    f"coverage {frame.get_coverage_ratio():.3f}, "
                    f"density {frame.get_scan_density():.3f}\n"
                )

    def _export_combined_pointcloud(self, output_dir: Path) -> None:
        """Combined cloud with per-frame viridis colours (reference: :306-337)."""
        all_points, all_colors = [], []
        n_frames = max(len(self.frames), 1)
        for i, frame in enumerate(self.frames):
            if len(frame.points) > 0:
                all_points.append(frame.points)
                c8 = np.clip(viridis_rgb(i / n_frames) * 255.0 + 0.5, 0,
                             255).astype(np.uint8)
                all_colors.append(np.broadcast_to(c8, (len(frame.points), 3)))
        if not all_points:
            return
        write_point_cloud(output_dir / "combined_pointcloud.ply",
                          np.vstack(all_points), colors=np.vstack(all_colors))

    def set_device_label_queries(self, points_flat, mask_flat) -> None:
        """Keep the scan's device-resident points for the label transfer.

        ``points_flat`` is the (W*R, 3) device tensor straight from the scan
        batch, ``mask_flat`` the HOST (W*R,) valid mask; the combined cloud
        is exactly the row-major masked flattening of the batch.
        """
        self._device_queries = points_flat
        self._device_mask = np.asarray(mask_flat).reshape(-1)

    def _export_combined_pointcloud_with_labels(self, output_dir: Path) -> None:
        """8-attribute labeled export (reference: :339-377), one batched 1-NN
        over the concatenated cloud."""
        all_points = [f.points for f in self.frames if len(f.points) > 0]
        if not all_points:
            return
        combined_points = np.vstack(all_points)
        t0 = time.time()
        combined_colors, combined_sem, combined_ins = (
            self._get_colors_and_labels_from_s3dis(combined_points)
        )
        # The callee records the cold-cache annotation disk load as
        # label_load: subtract it so the sub-spans are disjoint.
        self.profile["label_transfer"] = (
            time.time() - t0 - self.profile.get("label_load", 0.0)
        )
        colors_255 = (combined_colors * 255).astype(np.uint8)
        t0 = time.time()
        write_labeled_ply(
            output_dir / "combined_pointcloud_with_label.ply",
            combined_points,
            colors_255,
            combined_sem,
            combined_ins,
        )
        self.profile["export_ply_labeled"] = time.time() - t0

    # ------------------------------------------------------------------
    def _ensure_label_cache(self, on_critical_path: bool = True) -> bool:
        """Populate ``_s3dis_cache`` from the prefetch or a direct load.
        Returns False only when the scene has no annotation data."""
        if self._s3dis_cache is not None:
            return True
        with self._label_lock:
            if self._s3dis_cache is not None:
                return True
            t0 = time.time()
            grid = None
            if self.label_prefetch is not None:
                data = self.label_prefetch.join()
                grid = self.label_prefetch.grid
                self.profile["label_load_bg"] = self.label_prefetch.seconds
                for k, v in self.label_prefetch.spans.items():
                    self.profile[f"label_bg_{k}"] = float(v)
            else:
                data = self._load_s3dis_annotations_with_colors()
            dt = time.time() - t0
            self.profile["label_load"] = dt if on_critical_path else 0.0
            if not on_critical_path:
                self.profile["label_bg_join_wait"] = dt
            points, colors, labels, instances = data
            if points is None or len(points) == 0:
                return False
            if grid is None:
                grid = LabelGrid(np.asarray(points, np.float32), device=self.device)
            self._s3dis_cache = {
                "points": points, "colors": colors, "labels": labels,
                "instances": instances, "grid": grid,
            }
            return True

    def _label_nn(self, queries) -> np.ndarray:
        grid = self._s3dis_cache["grid"]
        idx = grid.query(queries)
        for k, v in grid.profile.items():
            self.profile[f"label_nn_{k}"] = float(v)
        return idx

    def start_label_transfer_async(self) -> None:
        """Run the 1-NN label transfer over the scan's device-resident
        points on a worker thread; ``_get_colors_and_labels_from_s3dis``
        joins it and re-raises whatever it raised."""
        dev_q = getattr(self, "_device_queries", None)
        if dev_q is None or getattr(self, "_device_mask", None) is None:
            return
        if not self.s3dis_data_root or not self.area or not self.room:
            return

        def _work():
            t0 = time.time()
            try:
                if not self._ensure_label_cache(on_critical_path=False):
                    self._async_idx = None
                    return
                # Only the valid rows: the rest are zero-filled misses.
                valid = torch.from_numpy(self._device_mask).to(dev_q.device)
                self._async_idx = self._label_nn(dev_q.reshape(-1, 3)[valid])
            except Exception as e:  # re-raised by the exporter's join
                self._transfer_error = e
            finally:
                self._async_seconds = time.time() - t0

        self._async_idx = None
        self._transfer_thread = threading.Thread(target=_work, daemon=True)
        self._transfer_thread.start()

    def _get_colors_and_labels_from_s3dis(self, points: np.ndarray):
        """1-NN transfer of (rgb, sem, ins) from the TLS cloud to ``points``."""
        if not self.s3dis_data_root or not self.area or not self.room:
            return self._get_default_colors_and_labels(len(points))
        thread = getattr(self, "_transfer_thread", None)
        idx = None
        if thread is not None:
            thread.join()
            self._transfer_thread = None
            if self._transfer_error is not None:
                raise self._transfer_error
            idx = self._async_idx
            if idx is not None and len(idx) != len(points):
                raise RuntimeError(
                    f"label transfer covered {len(idx)} points, the export "
                    f"has {len(points)}")
            self.profile["label_nn_bg"] = getattr(self, "_async_seconds", 0.0)
        if idx is None:
            if not self._ensure_label_cache():
                return self._get_default_colors_and_labels(len(points))
            idx = self._label_nn(np.asarray(points, dtype=np.float32))
        cache = self._s3dis_cache
        return cache["colors"][idx], cache["labels"][idx], cache["instances"][idx]

    def _load_s3dis_original_data(self):
        """Load the raw TLS cloud (xyz + rgb) for colour lookup (reference: :429-481)."""
        return _load_room_original_data(self.s3dis_data_root, self.area, self.room)

    @staticmethod
    def _load_s3dis_txt_pointcloud(file_path: str):
        """S3DIS txt: 'x y z r g b [label]' rows (reference: :483-503)."""
        return _load_room_txt_pointcloud(file_path)

    def _load_s3dis_annotations_with_colors(self):
        """Annotation cloud + colour match against the raw cloud (reference:
        :505-544)."""
        return load_room_label_data(self.s3dis_data_root, self.area, self.room,
                                    device=self.device)

    @staticmethod
    def _get_default_colors_and_labels(num_points: int):
        """Gray colours + zero labels for a scene without annotation data
        (reference: :575-584)."""
        colors = np.ones((num_points, 3), dtype=np.float32) * 0.5
        semantic_labels = np.zeros(num_points, dtype=np.uint16)
        instance_labels = np.zeros(num_points, dtype=np.uint16)
        return colors, semantic_labels, instance_labels

    def _decode_colors_to_labels(self, colors: np.ndarray):
        """Decode colours to (sem, ins) labels (reference: :586-612)."""
        encoder = S3DISColorEncoder(verbose=False)
        return encoder.decode_colors_to_labels_and_instances(colors)

    # ------------------------------------------------------------------
    def filter_frames_by_quality(
        self, min_coverage: float = 0.0, max_coverage: float = 1.0
    ) -> "S3DISSimScene":
        filtered = [
            f for f in self.frames if min_coverage <= f.get_coverage_ratio() <= max_coverage
        ]
        out = S3DISSimScene(self.scene_name, self.simulation_config, device=self.device)
        out.frames = filtered
        return out

    def get_best_frames(
        self, num_frames: int = 10, quality_metric: str = "coverage"
    ) -> List[S3DISSimFrame]:
        keys = {
            "coverage": lambda f: f.get_coverage_ratio(),
            "points": lambda f: f.get_num_points(),
            "density": lambda f: f.get_scan_density(),
        }
        if quality_metric not in keys:
            raise ValueError(f"Unsupported quality metric: {quality_metric}")
        return sorted(self.frames, key=keys[quality_metric], reverse=True)[:num_frames]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "scene_name": self.scene_name,
            "simulation_config": self.simulation_config,
            "frames": [f.to_dict() for f in self.frames],
            "statistics": self.statistics.to_dict() if self.statistics else None,
        }

    @classmethod
    def from_dict(cls, scene_dict: Dict[str, Any]) -> "S3DISSimScene":
        sim_scene = cls(
            scene_name=scene_dict["scene_name"],
            simulation_config=scene_dict.get("simulation_config", {}),
        )
        for frame_dict in scene_dict["frames"]:
            sim_scene.append_frame(S3DISSimFrame.from_dict(frame_dict))
        if scene_dict.get("statistics"):
            sim_scene.statistics = SimulationStats(**scene_dict["statistics"])
        return sim_scene

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"S3DISSimScene(name='{self.scene_name}', frames={self.get_total_frames()}, "
            f"points={self.get_total_points()}, "
            f"avg_coverage={self.get_average_coverage():.3f})"
        )
