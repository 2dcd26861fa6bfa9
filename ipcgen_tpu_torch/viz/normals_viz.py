"""Normal-estimation visualization (port of ``ipcgen_tpu/viz/normals_viz.py``).

Matplotlib renders of point clouds with normal glyphs, multi-view composites
coloured by normal direction, and normal statistics plots.  matplotlib is
imported at the first draw (``viz/_agg.py``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from ipcgen_tpu_torch.viz._agg import pyplot


def _write(fig, path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(path, dpi=150, bbox_inches="tight")


def visualize_normals(
    points: np.ndarray,
    normals: np.ndarray,
    colors: Optional[np.ndarray] = None,
    output_path: Optional[Path] = None,
    max_points: int = 5000,
    scale: float = 0.1,
    title: str = "Point Cloud Normals",
) -> Optional[Path]:
    """Quiver-style normals render (reference: :223-301)."""
    if normals is None:
        return None
    n = len(points)
    if n > max_points:
        sel = np.random.default_rng(0).choice(n, max_points, replace=False)
        points, normals = points[sel], normals[sel]
        colors = colors[sel] if colors is not None else None
    plt = pyplot()
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    c = colors if colors is not None else points[:, 2]
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], c=c, s=1)
    ax.quiver(
        points[:, 0], points[:, 1], points[:, 2],
        normals[:, 0], normals[:, 1], normals[:, 2],
        length=scale, color="red", alpha=0.4, linewidth=0.5,
    )
    ax.set_title(title)
    if output_path:
        output_path = Path(output_path)
        _write(fig, output_path)
    plt.close(fig)
    return Path(output_path) if output_path else None


def visualize_normals_high_quality(
    points: np.ndarray,
    normals: np.ndarray,
    colors: Optional[np.ndarray] = None,
    output_dir: Optional[Path] = None,
    max_points: int = 50000,
    title: str = "normals",
) -> Optional[Path]:
    """Four-camera-view composite colored by normal direction
    (reference: :303-572; Open3D renderer -> matplotlib)."""
    if normals is None:
        return None
    n = len(points)
    if n > max_points:
        sel = np.random.default_rng(0).choice(n, max_points, replace=False)
        points, normals = points[sel], normals[sel]
    normal_colors = (normals + 1.0) / 2.0
    views = [(30, 45), (30, 135), (30, 225), (75, 0)]
    plt = pyplot()
    fig = plt.figure(figsize=(16, 12))
    for i, (elev, azim) in enumerate(views):
        ax = fig.add_subplot(2, 2, i + 1, projection="3d")
        ax.scatter(
            points[:, 0], points[:, 1], points[:, 2], c=normal_colors, s=0.5
        )
        ax.view_init(elev=elev, azim=azim)
        ax.set_title(f"view {i + 1} (elev {elev}, azim {azim})")
    fig.suptitle(f"Normal directions - {title}")
    out = None
    if output_dir:
        out = Path(output_dir) / f"{title}_normals_hq.png"
        _write(fig, out)
    plt.close(fig)
    return out


def visualize_normal_statistics(
    normals: np.ndarray,
    output_path: Optional[Path] = None,
    title: str = "Normal statistics",
) -> Optional[Path]:
    """Component histograms + orientation distribution (reference: :574-632)."""
    if normals is None or len(normals) == 0:
        return None
    plt = pyplot()
    fig, axes = plt.subplots(2, 2, figsize=(12, 9))
    for i, name in enumerate(["nx", "ny", "nz"]):
        ax = axes.flat[i]
        ax.hist(normals[:, i], bins=50, color="steelblue", edgecolor="white")
        ax.set_title(f"{name} distribution")
        ax.grid(alpha=0.3)
    elevation = np.degrees(np.arcsin(np.clip(normals[:, 2], -1, 1)))
    axes[1, 1].hist(elevation, bins=36, color="seagreen", edgecolor="white")
    axes[1, 1].set_title("normal elevation (deg)")
    axes[1, 1].grid(alpha=0.3)
    fig.suptitle(title)
    out = None
    if output_path:
        out = Path(output_path)
        _write(fig, out)
    plt.close(fig)
    return out
