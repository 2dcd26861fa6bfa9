"""Trajectory visualization (port of ``ipcgen_tpu/viz/trajectory_viz.py``).

2-D top-down and 3-D trajectory renders with room bounds, furniture boxes,
yaw arrows and start/end markers, plus comparison and statistics plots.
matplotlib is imported at the first draw (``viz/_agg.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ipcgen_tpu_torch.viz._agg import pyplot, save_figure


class TrajectoryVisualizer:
    """Renders robot trajectories (reference: trajectory_visualizer.py:27-374)."""

    def __init__(self, output_dir: Optional[Path] = None):
        self.output_dir = Path(output_dir) if output_dir else Path(".")

    def _save(self, fig, name: str) -> Path:
        self.output_dir = Path(self.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        out = self.output_dir / name
        save_figure(fig, out)
        return out

    @staticmethod
    def _draw_room_2d(ax, room_bounds: Dict[str, float]) -> None:
        from matplotlib.patches import Rectangle

        ax.add_patch(
            Rectangle(
                (room_bounds["x_min"], room_bounds["y_min"]),
                room_bounds["x_max"] - room_bounds["x_min"],
                room_bounds["y_max"] - room_bounds["y_min"],
                fill=False,
                edgecolor="black",
                linewidth=2,
            )
        )

    def visualize_trajectory_2d(
        self,
        waypoints: List,
        room_bounds: Dict[str, float],
        furniture: Optional[List] = None,
        title: str = "Robot trajectory",
    ) -> Path:
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(10, 8))
        self._draw_room_2d(ax, room_bounds)
        xs = [w.x for w in waypoints]
        ys = [w.y for w in waypoints]
        ax.plot(xs, ys, "b.-", linewidth=1.5, markersize=4, label="trajectory")
        for w in waypoints[:: max(1, len(waypoints) // 20)]:
            ax.annotate(
                "",
                xy=(w.x + 0.2 * np.cos(w.yaw), w.y + 0.2 * np.sin(w.yaw)),
                xytext=(w.x, w.y),
                arrowprops=dict(arrowstyle="->", color="orange", lw=1),
            )
        if waypoints:
            ax.plot(xs[0], ys[0], "g^", markersize=12, label="start")
            ax.plot(xs[-1], ys[-1], "rs", markersize=12, label="end")
        if furniture:
            from matplotlib.patches import Rectangle

            for f in furniture:
                b = f.get_bounds()
                ax.add_patch(
                    Rectangle(
                        (b["x_min"], b["y_min"]),
                        b["x_max"] - b["x_min"],
                        b["y_max"] - b["y_min"],
                        facecolor="gray",
                        alpha=0.5,
                    )
                )
        ax.set_xlabel("X (m)")
        ax.set_ylabel("Y (m)")
        ax.set_title(title)
        ax.legend()
        ax.set_aspect("equal")
        ax.grid(alpha=0.3)
        return self._save(fig, "trajectory_2d.png")

    def visualize_trajectory_3d(
        self,
        waypoints: List,
        room_bounds: Dict[str, float],
        title: str = "Robot trajectory 3D",
    ) -> Path:
        plt = pyplot()
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
        xs = [w.x for w in waypoints]
        ys = [w.y for w in waypoints]
        zs = [w.z for w in waypoints]
        ax.plot(xs, ys, zs, "b.-", linewidth=1.5, markersize=3)
        if waypoints:
            ax.scatter(xs[0], ys[0], zs[0], c="g", s=80, marker="^", label="start")
            ax.scatter(xs[-1], ys[-1], zs[-1], c="r", s=80, marker="s", label="end")
        # Room wireframe
        x0, x1 = room_bounds["x_min"], room_bounds["x_max"]
        y0, y1 = room_bounds["y_min"], room_bounds["y_max"]
        z0, z1 = room_bounds["z_min"], room_bounds["z_max"]
        for za in (z0, z1):
            ax.plot([x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0], [za] * 5, "k-", lw=0.8)
        for xa in (x0, x1):
            for ya in (y0, y1):
                ax.plot([xa, xa], [ya, ya], [z0, z1], "k-", lw=0.8)
        ax.set_xlabel("X (m)")
        ax.set_ylabel("Y (m)")
        ax.set_zlabel("Z (m)")
        ax.set_title(title)
        ax.legend()
        return self._save(fig, "trajectory_3d.png")

    def visualize_trajectory_comparison(
        self,
        trajectories: Dict[str, List],
        room_bounds: Dict[str, float],
        title: str = "Trajectory comparison",
    ) -> Path:
        plt = pyplot()
        fig, ax = plt.subplots(figsize=(10, 8))
        self._draw_room_2d(ax, room_bounds)
        for name, waypoints in trajectories.items():
            ax.plot(
                [w.x for w in waypoints],
                [w.y for w in waypoints],
                ".-",
                linewidth=1.2,
                markersize=3,
                label=name,
            )
        ax.set_xlabel("X (m)")
        ax.set_ylabel("Y (m)")
        ax.set_title(title)
        ax.legend()
        ax.set_aspect("equal")
        ax.grid(alpha=0.3)
        return self._save(fig, "trajectory_comparison.png")

    def visualize_trajectory_statistics(
        self, waypoints: List, title: str = "Trajectory statistics"
    ) -> Path:
        plt = pyplot()
        fig, axes = plt.subplots(2, 2, figsize=(12, 9))
        pts = np.array([[w.x, w.y, w.z] for w in waypoints])
        yaws = np.array([w.yaw for w in waypoints])
        seg = np.linalg.norm(np.diff(pts, axis=0), axis=1) if len(pts) > 1 else np.zeros(0)
        axes[0, 0].plot(seg, "b.-")
        axes[0, 0].set_title("Segment lengths (m)")
        axes[0, 1].plot(np.degrees(yaws), "g.-")
        axes[0, 1].set_title("Yaw (deg)")
        axes[1, 0].plot(pts[:, 2], "r.-")
        axes[1, 0].set_title("Height (m)")
        axes[1, 1].hist(seg, bins=20, color="steelblue")
        axes[1, 1].set_title("Segment length histogram")
        for ax in axes.flat:
            ax.grid(alpha=0.3)
        fig.suptitle(title)
        return self._save(fig, "trajectory_statistics.png")
