"""Simulation scene visualization (port of ``ipcgen_tpu/viz/scene_viz.py``).

BEV scene plots, combined-cloud exports, frame sampling, a composite 3-D view,
and the markdown visualization summary.  matplotlib is imported at the first
draw (``viz/_agg.py``); the combined-cloud export takes its per-frame
colours from the port's viridis table and needs no matplotlib.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ipcgen_tpu_torch.io.ply import write_point_cloud
from ipcgen_tpu_torch.utils.viridis import viridis_rgb
from ipcgen_tpu_torch.viz._agg import pyplot, save_figure
from ipcgen_tpu_torch.viz.scan_viz import ScanResultVisualizer


class S3DISVisualizer:
    """Scene-level visualization helper (reference: s3dis_visualizer.py:24-332)."""

    def __init__(self, output_dir: Path):
        self.output_dir = Path(output_dir)
        self.vis_dir = self.output_dir / "visualizations"
        self.vis_dir.mkdir(parents=True, exist_ok=True)

    def _save(self, fig, name: str) -> Path:
        out = self.vis_dir / name
        save_figure(fig, out)
        return out

    def plot_scene_bev(self, sim_scene, scene, max_points: int = 50000) -> Optional[Path]:
        """BEV scatter of all frames over the room outline (reference: :42-118)."""
        pts = [f.points for f in sim_scene.frames if f.get_num_points() > 0]
        if not pts:
            return None
        all_pts = np.vstack(pts)
        if len(all_pts) > max_points:
            sel = np.random.default_rng(0).choice(len(all_pts), max_points, replace=False)
            all_pts = all_pts[sel]
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(10, 8))
        sc = ax.scatter(all_pts[:, 0], all_pts[:, 1], c=all_pts[:, 2], s=0.3,
                        cmap="viridis")
        fig.colorbar(sc, ax=ax, label="z (m)")
        b = scene.room_bounds
        ax.plot(
            [b.x_min, b.x_max, b.x_max, b.x_min, b.x_min],
            [b.y_min, b.y_min, b.y_max, b.y_max, b.y_min],
            "k-",
            lw=2,
        )
        ax.set_aspect("equal")
        ax.set_title(f"BEV - {sim_scene.scene_name}")
        return self._save(fig, "scene_bev.png")

    def export_combined_pointcloud(self, sim_scene, max_points: int = 2_000_000
                                   ) -> Optional[Path]:
        """Combined cloud PLY with per-frame colors (reference: :120-177)."""
        pts, colors = [], []
        n_frames = max(len(sim_scene.frames), 1)
        for i, f in enumerate(sim_scene.frames):
            if f.get_num_points() == 0:
                continue
            pts.append(f.points)
            colors.append(np.tile(viridis_rgb(i / n_frames), (f.get_num_points(), 1)))
        if not pts:
            return None
        all_pts = np.vstack(pts)
        all_colors = np.vstack(colors)
        if len(all_pts) > max_points:
            sel = np.random.default_rng(0).choice(len(all_pts), max_points, replace=False)
            all_pts, all_colors = all_pts[sel], all_colors[sel]
        out = self.vis_dir / "combined_frames.ply"
        write_point_cloud(out, all_pts, colors=all_colors)
        return out

    def sample_frames(self, sim_scene, num_sample_frames: int = 5) -> List:
        """Evenly sample frames for rendering (reference: :179-201)."""
        frames = [f for f in sim_scene.frames if f.get_num_points() > 0]
        if len(frames) <= num_sample_frames:
            return frames
        idx = np.linspace(0, len(frames) - 1, num_sample_frames).astype(int)
        return [frames[i] for i in idx]

    def plot_composite_3d(self, sim_scene, scene, max_points: int = 30000
                          ) -> Optional[Path]:
        """Composite 3-D render of sampled frames (reference: :241-332)."""
        frames = self.sample_frames(sim_scene, 5)
        if not frames:
            return None
        plt = pyplot()
        fig = plt.figure(figsize=(12, 9))
        ax = fig.add_subplot(111, projection="3d")
        for f in frames:
            pts = f.points
            if len(pts) > max_points // len(frames):
                sel = np.random.default_rng(0).choice(
                    len(pts), max_points // len(frames), replace=False
                )
                pts = pts[sel]
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.4,
                       label=f"frame {f.frame_index}")
        ax.set_title(f"Sampled frames - {sim_scene.scene_name}")
        ax.legend(markerscale=20)
        return self._save(fig, "composite_3d.png")

    def generate_all_visualizations(
        self, sim_scene, scene, num_sample_frames: int = 5
    ) -> Dict[str, Optional[str]]:
        """Generate the full set (reference: :203-239)."""
        results: Dict[str, Optional[str]] = {}
        results["scene_bev"] = _s(self.plot_scene_bev(sim_scene, scene))
        results["combined_pointcloud"] = _s(self.export_combined_pointcloud(sim_scene))
        results["composite_3d"] = _s(self.plot_composite_3d(sim_scene, scene))
        scan_viz = ScanResultVisualizer(self.vis_dir)
        for f in self.sample_frames(sim_scene, num_sample_frames):
            results[f"frame_{f.frame_index}"] = _s(scan_viz.visualize_frame_pointcloud(f))
        results["incident_angles"] = _s(
            scan_viz.visualize_incident_angle_distribution(sim_scene)
        )
        return results


def _s(p) -> Optional[str]:
    return str(p) if p is not None else None


def create_visualization_summary(viz_results: Dict[str, Optional[str]],
                                 output_dir: Path) -> Path:
    """Markdown index of generated visualizations (reference: :335-357)."""
    output_dir = Path(output_dir)
    out = output_dir / "visualization_summary.md"
    lines = ["# Visualization Summary", ""]
    for name, path in viz_results.items():
        if path:
            rel = Path(path).name
            lines.append(f"- **{name}**: `visualizations/{rel}`")
        else:
            lines.append(f"- **{name}**: (not generated)")
    out.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return out
