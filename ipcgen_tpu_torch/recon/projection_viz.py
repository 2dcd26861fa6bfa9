"""Reconstruction 2-D projection visualizer (port of
``ipcgen_tpu/recon/projection_viz.py``).

Three-panel XY/XZ/YZ scatter projections of the input point cloud and the
reconstructed mesh vertices (reference: s3dis_nksr_reconstructor.py:158-264),
gated by ``config['visualization']['save_visualizations']`` and subsampled to
``max_vis_points``.  matplotlib is imported only to draw, so the module
imports where matplotlib is missing (as on the GPU host); a draw asked for
there raises ``ImportError`` rather than skipping.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

# Per-panel depth colormaps used when no RGB colors are given
# (reference: s3dis_nksr_reconstructor.py:186-212).
_PANELS = (
    (0, 1, 2, "viridis", "XY", "X (m)", "Y (m)"),
    (0, 2, 1, "plasma", "XZ", "X (m)", "Z (m)"),
    (1, 2, 0, "coolwarm", "YZ", "Y (m)", "Z (m)"),
)


class ReconstructionVisualizer:
    """2-D projection renders for reconstruction outputs
    (reference: s3dis_nksr_reconstructor.py:158-264)."""

    def __init__(self, config_dict: dict):
        cfg = config_dict.get("visualization", config_dict) or {}
        self.save_visualizations = bool(cfg.get("save_visualizations", True))
        self.max_vis_points = int(cfg.get("max_vis_points", 10000))
        # Deterministic subsampling (no global RNG).
        self._rng = np.random.default_rng(int(cfg.get("seed", 0)))

    def _projections(
        self,
        pts: np.ndarray,
        colors: Optional[np.ndarray],
        output_path,
        title: str,
        point_size: float,
    ) -> Optional[Path]:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(1, 3, figsize=(18, 6))
        for ax, (ix, iy, ic, cmap, name, xl, yl) in zip(axes, _PANELS):
            if colors is not None:
                ax.scatter(pts[:, ix], pts[:, iy], c=colors,
                           s=point_size, alpha=0.6)
            else:
                ax.scatter(pts[:, ix], pts[:, iy], c=pts[:, ic],
                           s=point_size, alpha=0.6, cmap=cmap)
            ax.set_title(f"{title} - {name}")
            ax.set_xlabel(xl)
            ax.set_ylabel(yl)
            ax.axis("equal")
        plt.tight_layout()
        out = None
        if output_path:
            out = Path(output_path)
            out.parent.mkdir(parents=True, exist_ok=True)
            fig.savefig(out, dpi=150, bbox_inches="tight")
            print(f"[Visualization] Point cloud projections written to: {out}")
        plt.close(fig)
        return out

    def visualize_pointcloud(
        self,
        points,
        colors=None,
        output_path=None,
        title: str = "Point Cloud",
    ) -> Optional[Path]:
        """Three-panel point-cloud projections
        (reference: s3dis_nksr_reconstructor.py:164-223)."""
        if not self.save_visualizations:
            return None
        pts = np.asarray(points)
        cols = None if colors is None else np.asarray(colors)
        if len(pts) > self.max_vis_points:
            sel = self._rng.choice(len(pts), self.max_vis_points, replace=False)
            pts = pts[sel]
            cols = cols[sel] if cols is not None else None
        print(f"[Visualization] Rendering point cloud projections: {title}")
        return self._projections(pts, cols, output_path, title, point_size=0.5)

    def visualize_mesh_projection(
        self, mesh, output_path=None, title: str = "Mesh"
    ) -> Optional[Path]:
        """Three-panel mesh-vertex projections
        (reference: s3dis_nksr_reconstructor.py:225-264)."""
        if not self.save_visualizations:
            return None
        verts = np.asarray(mesh.vertices)
        if len(verts) > self.max_vis_points:
            sel = self._rng.choice(len(verts), self.max_vis_points, replace=False)
            verts = verts[sel]
        print(f"[Visualization] Rendering mesh projections: {title}")
        return self._projections(verts, None, output_path, title, point_size=0.1)
