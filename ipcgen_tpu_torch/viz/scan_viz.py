"""Scan result visualization (port of ``ipcgen_tpu/viz/scan_viz.py``).

Per-scene statistics grids, per-frame cloud renders colored by incident
angle, angle histograms, quality evolution, and a composite summary report.
matplotlib is imported at the first draw (``viz/_agg.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ipcgen_tpu_torch.viz._agg import pyplot, save_figure


class ScanResultVisualizer:
    """Renders simulated scan results (reference: scan_result_visualizer.py:29-424)."""

    def __init__(self, output_dir: Optional[Path] = None):
        self.output_dir = Path(output_dir) if output_dir else Path(".")

    def _save(self, fig, name: str) -> Path:
        self.output_dir = Path(self.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        out = self.output_dir / name
        save_figure(fig, out)
        return out

    def visualize_scan_statistics(self, sim_scene) -> Optional[Path]:
        """2x2 per-frame statistics grid (reference: :29-88)."""
        stats = sim_scene.get_frame_statistics()
        if not stats:
            return None
        plt = pyplot()
        fig, axes = plt.subplots(2, 2, figsize=(12, 9))
        idx = stats["frame_indices"]
        axes[0, 0].bar(idx, stats["point_counts"], color="steelblue")
        axes[0, 0].set_title("Points per frame")
        axes[0, 1].plot(idx, stats["coverage_ratios"], "g.-")
        axes[0, 1].set_title("Coverage ratio")
        axes[1, 0].plot(idx, stats["incident_angles"], "r.-")
        axes[1, 0].set_title("Mean incident angle (deg)")
        axes[1, 1].plot(idx, stats["ranges"], "m.-")
        axes[1, 1].set_title("Mean range (m)")
        for ax in axes.flat:
            ax.set_xlabel("frame")
            ax.grid(alpha=0.3)
        fig.suptitle(f"Scan statistics - {sim_scene.scene_name}")
        return self._save(fig, "scan_statistics.png")

    def visualize_frame_pointcloud(self, frame, title: Optional[str] = None) -> Optional[Path]:
        """3-D + BEV cloud render colored by incident angle (reference: :90-196)."""
        if frame.get_num_points() == 0:
            return None
        pts = frame.points
        ang = frame.incident_angles
        if len(pts) > 20000:
            sel = np.random.default_rng(0).choice(len(pts), 20000, replace=False)
            pts, ang = pts[sel], ang[sel]
        plt = pyplot()
        fig = plt.figure(figsize=(14, 6))
        ax3 = fig.add_subplot(121, projection="3d")
        sc = ax3.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=ang, s=0.5, cmap="viridis")
        ax3.set_title("3D view")
        fig.colorbar(sc, ax=ax3, shrink=0.6, label="incident angle (deg)")
        axb = fig.add_subplot(122)
        axb.scatter(pts[:, 0], pts[:, 1], c=ang, s=0.5, cmap="viridis")
        axb.set_title("BEV")
        axb.set_aspect("equal")
        fig.suptitle(title or f"Frame {frame.frame_index}")
        return self._save(fig, f"frame_{frame.frame_index:04d}_pointcloud.png")

    def visualize_incident_angle_distribution(self, sim_scene) -> Optional[Path]:
        """Angle histograms across frames (reference: :198-246)."""
        all_angles = np.concatenate(
            [f.incident_angles for f in sim_scene.frames if f.get_num_points() > 0]
        ) if sim_scene.frames else np.zeros(0)
        if len(all_angles) == 0:
            return None
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.hist(all_angles, bins=36, color="steelblue", edgecolor="white")
        ax.set_xlabel("incident angle (deg)")
        ax.set_ylabel("count")
        ax.set_title(f"Incident angle distribution - {sim_scene.scene_name}")
        ax.grid(alpha=0.3)
        return self._save(fig, "incident_angle_distribution.png")

    def visualize_scan_quality_evolution(self, sim_scene) -> Optional[Path]:
        """Quality evolution + radar chart (reference: :248-320)."""
        stats = sim_scene.get_frame_statistics()
        if not stats:
            return None
        plt = pyplot()
        fig = plt.figure(figsize=(14, 6))
        ax1 = fig.add_subplot(121)
        ax1.plot(stats["frame_indices"], stats["coverage_ratios"], "g.-", label="coverage")
        dens = np.asarray(stats["scan_densities"], dtype=float)
        if dens.max() > 0:
            ax1.plot(stats["frame_indices"], dens / dens.max(), "b.-", label="density (norm)")
        ax1.set_xlabel("frame")
        ax1.legend()
        ax1.grid(alpha=0.3)
        ax1.set_title("Quality evolution")

        ax2 = fig.add_subplot(122, projection="polar")
        metrics = {
            "coverage": float(np.mean(stats["coverage_ratios"])),
            "density": float(np.clip(dens.mean() / max(dens.max(), 1e-9), 0, 1)),
            "points": float(
                np.mean(stats["point_counts"]) / max(np.max(stats["point_counts"]), 1)
            ),
            "angle": float(
                1.0 - np.mean(stats["incident_angles"]) / 90.0
            ),
        }
        labels = list(metrics.keys())
        values = list(metrics.values()) + [list(metrics.values())[0]]
        angles = np.linspace(0, 2 * np.pi, len(labels), endpoint=False).tolist()
        angles += [angles[0]]
        ax2.plot(angles, values, "b-", linewidth=2)
        ax2.fill(angles, values, alpha=0.25)
        ax2.set_xticks(angles[:-1])
        ax2.set_xticklabels(labels)
        ax2.set_title("Quality radar")
        return self._save(fig, "scan_quality_evolution.png")

    def create_scan_summary_report(self, sim_scene) -> Optional[Path]:
        """Composite summary PNG (reference: :322-424)."""
        stats = sim_scene.get_frame_statistics()
        if not stats:
            return None
        plt = pyplot()
        fig = plt.figure(figsize=(14, 10))
        gs = fig.add_gridspec(3, 2)
        ax_txt = fig.add_subplot(gs[0, :])
        ax_txt.axis("off")
        s = sim_scene.statistics
        lines = [
            f"Scene: {sim_scene.scene_name}",
            f"Frames: {sim_scene.get_total_frames()}   Points: {sim_scene.get_total_points():,}",
            f"Avg coverage: {sim_scene.get_average_coverage():.3f}   "
            f"Avg density: {sim_scene.get_average_scan_density():.3f}",
            f"Avg incident angle: {sim_scene.get_average_incident_angle():.1f} deg   "
            f"Avg range: {sim_scene.get_average_range():.2f} m",
        ]
        if s:
            lines.append(
                f"Simulation time: {s.simulation_time:.2f}s   FPS: {s.frames_per_second:.1f}"
            )
        ax_txt.text(
            0.02, 0.9, "\n".join(lines), fontsize=12, family="monospace", va="top"
        )
        ax1 = fig.add_subplot(gs[1, 0])
        ax1.bar(stats["frame_indices"], stats["point_counts"], color="steelblue")
        ax1.set_title("Points per frame")
        ax2 = fig.add_subplot(gs[1, 1])
        ax2.plot(stats["frame_indices"], stats["coverage_ratios"], "g.-")
        ax2.set_title("Coverage")
        ax3 = fig.add_subplot(gs[2, 0])
        ax3.plot(stats["frame_indices"], stats["incident_angles"], "r.-")
        ax3.set_title("Mean incident angle")
        ax4 = fig.add_subplot(gs[2, 1])
        ax4.plot(stats["frame_indices"], stats["ranges"], "m.-")
        ax4.set_title("Mean range")
        for ax in (ax1, ax2, ax3, ax4):
            ax.grid(alpha=0.3)
        return self._save(fig, "scan_summary_report.png")
