"""The check of one room's sim-stage output against the reference.

The program's output is the room's labeled PLY: the frames' hit points
one frame after another, each with a semantic and an instance label.  The
program's own state supplies each frame's sensor pose and point count,
which split the PLY's rows into frames.  The reference works out again the
trajectory (``benchmark/planner.py`` over the room's mesh) and the ray
pattern (``reference.sensor_pattern``).  Checked:

- layout: one frame per waypoint of the reference's trajectory, and the
  frames' counts add up to the PLY's rows;
- waypoints: each frame's pose, as float32, equal to the reference's
  (``waypoints_off`` counts those that are not: an exact comparison);
- frame counts: each frame's points against the rays the stated LiDAR
  profile casts less its stated dropout: the largest relative deviation
  (``frame_count_dev``) and the largest in standard deviations of the
  stated dropout's binomial law (``frame_count_z``);
- rays: for a sample of rows drawn from the seed, the angle between the
  point's direction from the reference's pose, in the sensor's frame, and
  the nearest ray of the pattern (``ray_gap_mrad``, the widest);
- twins: the share of rows whose coordinates another row has, bit for bit
  (``twin_share``): no two rays of a scan end in the same float32 point;
- hits: for the sample, the ray from the reference's origin through the
  point must first meet a surface at that point (``reference.hit_gaps``
  over the room's triangles, float64), within ``hit_tol_m``;
- labels: for a sample of those rows, the (semantic, instance) label must
  be that of a nearest TLS point (``reference.LabelReference``, exact).

With ``control`` the program's points and labels are replaced by the
reference's own computed in bfloat16 (the precision below the
configuration's float32), along the same rays, and its trajectory by the
planner's over the mesh's vertices in bfloat16: the control of
``benchmark/control.py``.  Its twins are counted among the sample.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark import reference


def room_numbers(ply_path, poses, counts, ref_poses, tris,
                 labels: "reference.LabelReference", pattern: "reference.RayPattern",
                 rays: int, dropout: float, rng: np.random.Generator, hit_samples: int,
                 label_samples: int, hit_tol_m: float, label_tol_m: float, device,
                 control: bool = False) -> Dict:
    """Counts of one room: layout_bad, waypoints_off, frame_count_dev,
    frame_count_z, ray_gap_mrad, twin_share, hit_checked, hit_off,
    label_checked, label_off.  ``poses`` are the program's (or, with
    ``control``, the control's) float32 poses, ``ref_poses`` the
    reference's."""
    pts, sem, ins = reference.read_labeled_cloud(ply_path)
    counts = np.asarray(counts, np.int64)
    poses, ref_poses = np.asarray(poses, np.float32), np.asarray(ref_poses, np.float32)
    out = {"layout_bad": 0, "waypoints_off": 0, "frame_count_dev": 0.0, "frame_count_z": 0.0,
           "ray_gap_mrad": 0.0, "twin_share": 0.0, "hit_checked": 0, "hit_off": 0,
           "label_checked": 0, "label_off": 0}
    if (len(counts) != len(ref_poses) or len(poses) != len(ref_poses)
            or counts.sum() != len(pts) or len(pts) == 0):
        out["layout_bad"] = 1
        return out
    out["waypoints_off"] = int(np.sum(np.any(poses != ref_poses, axis=(1, 2))))
    row_frame = np.repeat(np.arange(len(counts)), counts)
    pick = rng.choice(len(pts), size=min(hit_samples, len(pts)), replace=False)
    ref64 = ref_poses.astype(np.float64)
    o = ref64[row_frame[pick], :3, 3]
    p, s, k = pts[pick], sem[pick], ins[pick]
    if control:
        rel = p - o
        dirs = rel / np.linalg.norm(rel, axis=1, keepdims=True)
        p = reference.cast_points(o, dirs, tris, device, torch.bfloat16)
        # A ray the bfloat16 cast misses gives no point: its frame counts
        # one fewer (by the sample's share), and it counts as off.
        hit = np.all(np.isfinite(p), axis=1)
        share = np.bincount(row_frame[pick], hit, len(counts)) / np.maximum(
            np.bincount(row_frame[pick], minlength=len(counts)), 1)
        counts = np.rint(counts * share)
        p[~hit] = 1e6
        s, k = labels.labels(p, torch.bfloat16)
        out["twin_share"] = reference.twin_share(p, device)
    else:
        out["twin_share"] = reference.twin_share(pts, device)
    expected = rays * (1.0 - dropout)
    sigma = max(np.sqrt(rays * dropout * (1.0 - dropout)), 1.0)
    out["frame_count_dev"] = float(np.max(np.abs(counts - expected)) / expected)
    out["frame_count_z"] = float(np.max(np.abs(counts - expected)) / sigma)
    out["ray_gap_mrad"] = float(1e3 * pattern.gaps(p, ref64[row_frame[pick]]).max())
    gaps = reference.hit_gaps(p, o, tris, device)
    out["hit_checked"] = len(gaps)
    out["hit_off"] = int(np.sum(~(gaps <= hit_tol_m)))
    n_lab = min(label_samples, len(p))
    wrong = labels.wrong(p[:n_lab], s[:n_lab], k[:n_lab], label_tol_m)
    out["label_checked"] = n_lab
    out["label_off"] = int(wrong.sum())
    return out


def combine(per_room) -> Dict[str, float]:
    """The cell's numbers over its rooms."""
    hit_checked = sum(r["hit_checked"] for r in per_room)
    label_checked = sum(r["label_checked"] for r in per_room)
    return {
        "layout_bad": float(sum(r["layout_bad"] for r in per_room)),
        "waypoints_off": float(sum(r["waypoints_off"] for r in per_room)),
        "frame_count_dev": max([r["frame_count_dev"] for r in per_room], default=0.0),
        "frame_count_z": max([r["frame_count_z"] for r in per_room], default=0.0),
        "ray_gap_mrad": max([r["ray_gap_mrad"] for r in per_room], default=0.0),
        "twin_share": max([r["twin_share"] for r in per_room], default=0.0),
        "hit_off_share": sum(r["hit_off"] for r in per_room) / max(hit_checked, 1),
        "label_off_share": sum(r["label_off"] for r in per_room) / max(label_checked, 1),
    }
