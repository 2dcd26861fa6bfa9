"""Mesh visualization (port of ``ipcgen_tpu/viz/mesh_viz.py``).

Poly3DCollection room renders, mesh+trajectory overlays, furniture overlays,
and mesh statistics plots.  matplotlib (and ``mpl_toolkits.mplot3d``) is
imported at the first draw (``viz/_agg.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ipcgen_tpu_torch.viz._agg import pyplot, save_figure


def _poly3d(*args, **kwargs):
    from mpl_toolkits.mplot3d.art3d import Poly3DCollection

    return Poly3DCollection(*args, **kwargs)


class MeshVisualizer:
    """Renders room meshes (reference: mesh_visualizer.py:25-355)."""

    def __init__(self, output_dir: Optional[Path] = None, max_faces: int = 5000):
        self.output_dir = Path(output_dir) if output_dir else Path(".")
        self.max_faces = max_faces

    def _save(self, fig, name: str) -> Path:
        self.output_dir = Path(self.output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        out = self.output_dir / name
        save_figure(fig, out)
        return out

    def _sampled_faces(self, mesh) -> np.ndarray:
        corners = mesh.triangle_corners()
        if len(corners) > self.max_faces:
            sel = np.random.default_rng(0).choice(
                len(corners), self.max_faces, replace=False
            )
            corners = corners[sel]
        return corners

    def visualize_room_mesh(
        self, mesh, room_bounds: Dict[str, float], title: str = "Room mesh"
    ) -> Path:
        plt = pyplot()
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
        faces = self._sampled_faces(mesh)
        coll = _poly3d(faces, alpha=0.3, facecolor="lightsteelblue",
                       edgecolor="gray", linewidths=0.1)
        ax.add_collection3d(coll)
        ax.set_xlim(room_bounds["x_min"], room_bounds["x_max"])
        ax.set_ylim(room_bounds["y_min"], room_bounds["y_max"])
        ax.set_zlim(room_bounds["z_min"], room_bounds["z_max"])
        ax.set_title(title)
        return self._save(fig, "room_mesh.png")

    def visualize_mesh_with_trajectory(
        self,
        mesh,
        waypoints: List,
        room_bounds: Dict[str, float],
        title: str = "Room and trajectory",
    ) -> Path:
        plt = pyplot()
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
        faces = self._sampled_faces(mesh)
        ax.add_collection3d(_poly3d(faces, alpha=0.2, facecolor="lightsteelblue"))
        ax.plot(
            [w.x for w in waypoints],
            [w.y for w in waypoints],
            [w.z for w in waypoints],
            "r.-",
            linewidth=2,
        )
        ax.set_xlim(room_bounds["x_min"], room_bounds["x_max"])
        ax.set_ylim(room_bounds["y_min"], room_bounds["y_max"])
        ax.set_zlim(room_bounds["z_min"], room_bounds["z_max"])
        ax.set_title(title)
        return self._save(fig, "mesh_with_trajectory.png")

    def visualize_mesh_with_furniture(
        self,
        mesh,
        furniture: List,
        room_bounds: Dict[str, float],
        title: str = "Room and furniture",
    ) -> Path:
        plt = pyplot()
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
        ax.add_collection3d(
            _poly3d(self._sampled_faces(mesh), alpha=0.15, facecolor="lightsteelblue")
        )
        for f in furniture:
            b = f.get_bounds()
            self._draw_box(ax, b, color="sienna")
        ax.set_xlim(room_bounds["x_min"], room_bounds["x_max"])
        ax.set_ylim(room_bounds["y_min"], room_bounds["y_max"])
        ax.set_zlim(room_bounds["z_min"], room_bounds["z_max"])
        ax.set_title(title)
        return self._save(fig, "mesh_with_furniture.png")

    @staticmethod
    def _draw_box(ax, b: Dict[str, float], color="sienna") -> None:
        x0, x1 = b["x_min"], b["x_max"]
        y0, y1 = b["y_min"], b["y_max"]
        z0, z1 = b["z_min"], b["z_max"]
        for za in (z0, z1):
            ax.plot([x0, x1, x1, x0, x0], [y0, y0, y1, y1, y0], [za] * 5, color=color)
        for xa in (x0, x1):
            for ya in (y0, y1):
                ax.plot([xa, xa], [ya, ya], [z0, z1], color=color)

    def visualize_mesh_statistics(
        self, mesh, room_bounds: Dict[str, float], title: str = "Mesh statistics"
    ) -> Path:
        plt = pyplot()
        fig, axes = plt.subplots(2, 2, figsize=(12, 9))
        areas = mesh.triangle_areas()
        verts = np.asarray(mesh.vertices)
        axes[0, 0].hist(areas, bins=40, color="steelblue")
        axes[0, 0].set_title("Triangle areas")
        axes[0, 0].set_yscale("log")
        axes[0, 1].hist(verts[:, 2], bins=40, color="seagreen")
        axes[0, 1].set_title("Vertex height distribution")
        axes[1, 0].axis("off")
        axes[1, 0].text(
            0.05,
            0.9,
            (
                f"Vertices: {mesh.num_vertices:,}\n"
                f"Triangles: {mesh.num_triangles:,}\n"
                f"Surface area: {mesh.surface_area():.2f} m^2\n"
                f"Bounds volume: "
                f"{np.prod(np.diff(mesh.bounds(), axis=0)):.2f} m^3"
            ),
            family="monospace",
            fontsize=12,
            va="top",
        )
        axes[1, 1].scatter(verts[::7, 0], verts[::7, 1], s=0.3, c=verts[::7, 2],
                           cmap="viridis")
        axes[1, 1].set_title("Vertex BEV")
        axes[1, 1].set_aspect("equal")
        fig.suptitle(title)
        return self._save(fig, "mesh_statistics.png")
