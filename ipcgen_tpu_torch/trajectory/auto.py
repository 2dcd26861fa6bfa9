"""Automatic trajectory generation from room layout.

API-parity rewrite of reference trajectory/auto_trajectory_generator.py:42-705
with the quadratic host loops vectorized:

- free-space cell classification (reference :131-143, a per-cell Python loop
  with an O(V) vertex test each) becomes one binned numpy pass over vertices;
- the O(n^2) connectivity scan (:245-258) becomes a vectorized pairwise
  distance block;
- A* uses a heap instead of a linear min-scan (:439-441) — same path.

Scoring, smoothing, and waypoint resampling keep the reference's exact
formulas (validated in tests/test_trajectory.py).
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ipcgen_tpu_torch.trajectory.collision import CollisionDetector, FurnitureInfo
from ipcgen_tpu_torch.trajectory.waypoint import TrajectoryQuality, Waypoint


@dataclass
class RoomAnalysis:
    """Room layout analysis results (reference: :18-27)."""

    bounds: Dict[str, float]
    center: np.ndarray
    dimensions: np.ndarray
    free_space_points: List[np.ndarray]
    obstacle_points: List[np.ndarray]
    connectivity_graph: Dict[int, List[int]]
    mesh: object


@dataclass
class TrajectoryCandidate:
    """One candidate path (reference: :30-39)."""

    start_point: np.ndarray
    end_point: np.ndarray
    waypoints: List[Waypoint]
    quality: TrajectoryQuality
    length: float
    collision_count: int
    smoothness_score: float


class AutoTrajectoryGenerator:
    """Layout-aware optimal trajectory generator (reference: :42-705)."""

    def __init__(
        self,
        robot_radius: float = 0.3,
        min_trajectory_length: Optional[float] = None,
        seed: Optional[int] = None,
        occupancy_mode: str = "vertices",
        scene_asset=None,
    ):
        """``occupancy_mode``: "vertices" keeps the reference's vertex-in-AABB
        cell test; "raycast" classifies cells with one batched probe-ray query
        against ``scene_asset`` through the pair raycast kernel
        (ipcgen_tpu_torch.ops.occupancy — sees triangle surfaces, not just
        vertices)."""
        self.robot_radius = robot_radius
        self.min_trajectory_length = min_trajectory_length
        self.collision_detector = CollisionDetector(robot_radius)
        self.room_analysis: Optional[RoomAnalysis] = None
        self.rng = np.random.default_rng(seed)
        self.occupancy_mode = occupancy_mode
        self.scene_asset = scene_asset

        # Generation parameters (reference: :54-62)
        self.grid_resolution = 0.2
        self.min_free_space = 1.0
        self.max_candidates = 40
        self.sampling_density = 0.1
        self.interpolation_density = 2.0
        self.min_waypoints = 40
        self.robot_height = 1.0

    # ------------------------------------------------------------------
    def generate_optimal_trajectory(
        self, mesh, room_bounds: Dict[str, float], num_waypoints: int = 20
    ) -> Tuple[List[Waypoint], Dict[str, Any]]:
        """Analyze -> candidates -> select best (reference: :64-95)."""
        self.room_analysis = self._analyze_room_layout(mesh, room_bounds)
        dense_waypoints = max(
            int(num_waypoints * self.interpolation_density), self.min_waypoints
        )
        candidates = self._generate_trajectory_candidates(dense_waypoints)
        best_candidate = self._select_best_trajectory(candidates)
        analysis_info = self._generate_analysis_info(candidates, best_candidate)
        return best_candidate.waypoints, analysis_info

    # ------------------------------------------------------------------
    def _classify_cells(
        self, mesh, room_bounds: Dict[str, float], resolution: float
    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
        """Vectorized free/obstacle classification at robot height.

        Semantics match the reference exactly: a cell is an obstacle when any
        mesh vertex falls inside the robot's cube AABB centered on the cell
        (:219-238); cells whose robot AABB leaves the room are skipped
        (:204-216).
        """
        r = self.robot_radius
        z = self.robot_height
        xs = np.arange(room_bounds["x_min"], room_bounds["x_max"], resolution)
        ys = np.arange(room_bounds["y_min"], room_bounds["y_max"], resolution)
        if len(xs) == 0 or len(ys) == 0:
            return [], []

        in_bounds_x = (xs - r >= room_bounds["x_min"]) & (xs + r <= room_bounds["x_max"])
        in_bounds_y = (ys - r >= room_bounds["y_min"]) & (ys + r <= room_bounds["y_max"])
        z_ok = (z - r >= room_bounds["z_min"]) and (z + r <= room_bounds["z_max"])

        occupied = np.zeros((len(xs), len(ys)), dtype=bool)
        if self.occupancy_mode == "raycast" and self.scene_asset is not None:
            from ipcgen_tpu_torch.ops.occupancy import obstacle_mask

            gx, gy = np.meshgrid(xs, ys, indexing="ij")
            cells = np.stack(
                [gx.ravel(), gy.ravel(), np.full(gx.size, z)], axis=1
            )
            occupied = obstacle_mask(
                self.scene_asset, cells, r
            ).reshape(len(xs), len(ys))
            verts = np.zeros((0, 3))
        else:
            verts = np.asarray(mesh.vertices)
        if len(verts) > 0:
            band = verts[(verts[:, 2] >= z - r) & (verts[:, 2] <= z + r)]
            if len(band) > 0:
                ilo = np.searchsorted(xs, band[:, 0] - r, "left")
                ihi = np.searchsorted(xs, band[:, 0] + r, "right")
                jlo = np.searchsorted(ys, band[:, 1] - r, "left")
                jhi = np.searchsorted(ys, band[:, 1] + r, "right")
                wi = int(max((ihi - ilo).max(initial=0), 0))
                wj = int(max((jhi - jlo).max(initial=0), 0))
                for di in range(wi):
                    for dj in range(wj):
                        m = (ilo + di < ihi) & (jlo + dj < jhi)
                        occupied[ilo[m] + di, jlo[m] + dj] = True

        free_space_points: List[np.ndarray] = []
        obstacle_points: List[np.ndarray] = []
        # Iterate x-major, y-minor like the reference loops (:131-143) so the
        # free-space point ordering (and thus random candidate draws) matches.
        for i, x in enumerate(xs):
            if not in_bounds_x[i] or not z_ok:
                continue
            for j, y in enumerate(ys):
                if not in_bounds_y[j]:
                    continue
                point = np.array([x, y, z])
                if occupied[i, j]:
                    obstacle_points.append(point)
                else:
                    free_space_points.append(point)
        return free_space_points, obstacle_points

    def _analyze_room_layout(
        self, mesh, room_bounds: Dict[str, float]
    ) -> RoomAnalysis:
        """Grid-sample free space + build connectivity (reference: :97-160)."""
        center = np.array(
            [
                (room_bounds["x_max"] + room_bounds["x_min"]) / 2,
                (room_bounds["y_max"] + room_bounds["y_min"]) / 2,
                (room_bounds["z_max"] + room_bounds["z_min"]) / 2,
            ]
        )
        dimensions = np.array(
            [
                room_bounds["x_max"] - room_bounds["x_min"],
                room_bounds["y_max"] - room_bounds["y_min"],
                room_bounds["z_max"] - room_bounds["z_min"],
            ]
        )
        if self.min_trajectory_length is None:
            self.min_trajectory_length = max(dimensions[0], dimensions[1]) * 0.2

        coarse_resolution = max(0.2, float(min(dimensions)) / 20)
        free_pts, obst_pts = self._classify_cells(mesh, room_bounds, coarse_resolution)

        if len(free_pts) < 10:
            # Finer fallback pass (reference: :146-147, :162-202)
            fine_resolution = max(0.15, float(min(dimensions)) / 30)
            free_pts, obst_pts = self._classify_cells(mesh, room_bounds, fine_resolution)

        connectivity_graph = self._build_connectivity_graph(free_pts)
        return RoomAnalysis(
            bounds=room_bounds,
            center=center,
            dimensions=dimensions,
            free_space_points=free_pts,
            obstacle_points=obst_pts,
            connectivity_graph=connectivity_graph,
            mesh=mesh,
        )

    def _is_point_in_room_bounds(
        self, point: np.ndarray, room_bounds: Dict[str, float]
    ) -> bool:
        """Robot AABB fully inside the room (reference: :204-216)."""
        r = self.robot_radius
        lo = point - r
        hi = point + r
        return bool(
            room_bounds["x_min"] <= lo[0]
            and hi[0] <= room_bounds["x_max"]
            and room_bounds["y_min"] <= lo[1]
            and hi[1] <= room_bounds["y_max"]
            and room_bounds["z_min"] <= lo[2]
            and hi[2] <= room_bounds["z_max"]
        )

    def _is_point_inside_mesh(self, point: np.ndarray, mesh) -> bool:
        """Any vertex inside the robot cube AABB (reference: :219-238)."""
        vertices = np.asarray(mesh.vertices)
        if len(vertices) == 0:
            return False
        lo = point - self.robot_radius
        hi = point + self.robot_radius
        return bool(np.any(np.all((vertices >= lo) & (vertices <= hi), axis=1)))

    def _has_sufficient_free_space(self, point: np.ndarray, mesh) -> bool:
        return not self._is_point_inside_mesh(point, mesh)

    def _build_connectivity_graph(
        self, free_space_points: List[np.ndarray]
    ) -> Dict[int, List[int]]:
        """Cells within 2x robot radius are connected (reference: :245-258).

        The reference's O(n^2) Python double loop becomes one vectorized
        pairwise-distance computation.
        """
        n = len(free_space_points)
        if n == 0:
            return {}
        pts = np.asarray(free_space_points)
        max_distance = self.robot_radius * 2
        # (n, n) distances; free-space cell counts are grid-bounded (<= ~10^4)
        d2 = np.sum((pts[:, None, :] - pts[None, :, :]) ** 2, axis=2)
        adj = (d2 <= max_distance**2) & ~np.eye(n, dtype=bool)
        return {i: np.nonzero(adj[i])[0].tolist() for i in range(n)}

    # ------------------------------------------------------------------
    def _generate_trajectory_candidates(
        self, num_waypoints: int
    ) -> List[TrajectoryCandidate]:
        """Random start/end pairs filtered by min length (reference: :260-298)."""
        candidates: List[TrajectoryCandidate] = []
        free_space_points = self.room_analysis.free_space_points
        if len(free_space_points) < 2:
            return candidates
        max_attempts = min(self.max_candidates, len(free_space_points) * 2)
        for _ in range(max_attempts):
            start_idx = int(self.rng.integers(0, len(free_space_points)))
            end_idx = int(self.rng.integers(0, len(free_space_points)))
            if start_idx == end_idx:
                continue
            start_point = free_space_points[start_idx]
            end_point = free_space_points[end_idx]
            if np.linalg.norm(start_point - end_point) < self.min_trajectory_length:
                continue
            candidate = self._create_trajectory_candidate(
                start_point, end_point, num_waypoints
            )
            if candidate is not None:
                candidates.append(candidate)
        return candidates

    def _create_trajectory_candidate(
        self, start_point: np.ndarray, end_point: np.ndarray, num_waypoints: int
    ) -> Optional[TrajectoryCandidate]:
        """A* through free space, resample, smooth, score (reference: :300-388)."""
        try:
            free_space_points = self.room_analysis.free_space_points
            if len(free_space_points) < 2:
                waypoints = self._generate_linear_waypoints(
                    start_point, end_point, num_waypoints
                )
            else:
                start_idx = self._find_nearest_free_space_point(
                    start_point, free_space_points
                )
                end_idx = self._find_nearest_free_space_point(
                    end_point, free_space_points
                )
                if start_idx is None or end_idx is None:
                    waypoints = self._generate_linear_waypoints(
                        start_point, end_point, num_waypoints
                    )
                else:
                    path_indices = self._a_star_search(
                        start_idx, end_idx, free_space_points
                    )
                    if path_indices is None or len(path_indices) < 2:
                        waypoints = self._generate_linear_waypoints(
                            start_point, end_point, num_waypoints
                        )
                    else:
                        path_points = [free_space_points[i] for i in path_indices]
                        if not np.allclose(path_points[0], start_point, atol=0.1):
                            path_points.insert(0, start_point)
                        if not np.allclose(path_points[-1], end_point, atol=0.1):
                            path_points.append(end_point)
                        if len(path_points) == 2:
                            waypoints = self._generate_linear_waypoints(
                                path_points[0], path_points[1], num_waypoints
                            )
                        else:
                            waypoints = self._generate_waypoints_along_path(
                                path_points, num_waypoints
                            )
                            waypoints = self._smooth_trajectory(waypoints)

            collision_count = self._count_waypoint_collisions(waypoints)

            length = self._calculate_trajectory_length(waypoints)
            smoothness_score = self._calculate_smoothness_score(waypoints)
            quality = TrajectoryQuality(
                coverage_ratio=(
                    1.0 - (collision_count / len(waypoints)) if waypoints else 0.0
                ),
                path_length=length,
                turn_count=self._count_turns(waypoints),
                efficiency=(
                    1.0
                    if collision_count == 0
                    else max(0.0, 1.0 - collision_count / len(waypoints))
                ),
                collision_count=collision_count,
                smoothness=smoothness_score,
            )
            return TrajectoryCandidate(
                start_point=start_point,
                end_point=end_point,
                waypoints=waypoints,
                quality=quality,
                length=length,
                collision_count=collision_count,
                smoothness_score=smoothness_score,
            )
        except Exception:
            return None

    def _count_waypoint_collisions(self, waypoints: List[Waypoint]) -> int:
        """Vectorized collision recount over a candidate's waypoints.

        Same semantics as the reference's per-waypoint loop (:347-359): a
        waypoint collides when its robot AABB leaves the room OR any mesh
        vertex falls inside it.  Vertices are prefiltered once to the robot's
        z band, then all waypoints test against that band in one numpy pass.
        """
        if not waypoints:
            return 0
        b = self.room_analysis.bounds
        r = self.robot_radius
        pts = np.array([[w.x, w.y, w.z] for w in waypoints])  # (W, 3)
        out_of_bounds = ~(
            (b["x_min"] <= pts[:, 0] - r) & (pts[:, 0] + r <= b["x_max"])
            & (b["y_min"] <= pts[:, 1] - r) & (pts[:, 1] + r <= b["y_max"])
            & (b["z_min"] <= pts[:, 2] - r) & (pts[:, 2] + r <= b["z_max"])
        )
        mesh = self.room_analysis.mesh
        verts = np.asarray(mesh.vertices) if mesh is not None else np.zeros((0, 3))
        hits = np.zeros(len(pts), dtype=bool)
        if len(verts):
            z_lo = pts[:, 2].min() - r
            z_hi = pts[:, 2].max() + r
            grid = self._band_cell_grid(verts, z_lo, z_hi, r)
            if grid is not None:
                band, starts, lo0, inv_h, nx, ny = grid
                # Broad phase: the <=3x3 cells the robot AABB overlaps;
                # narrow phase: exact vertex-in-AABB over those cells only.
                # Same result as the full (W, V') test — every band vertex
                # inside the AABB lies in an overlapped cell — at ~1% of
                # the comparisons (the recount was 2/3 of the trajectory
                # stage's 2.5 s/room).
                c0 = np.floor((pts[:, :2] - r - lo0) * inv_h).astype(np.int64)
                c1 = np.floor((pts[:, :2] + r - lo0) * inv_h).astype(np.int64)
                c0 = np.clip(c0, 0, [nx - 1, ny - 1])
                c1 = np.clip(c1, 0, [nx - 1, ny - 1])
                for i in range(len(pts)):
                    lo = pts[i] - r
                    hi = pts[i] + r
                    hit = False
                    for cx in range(c0[i, 0], c1[i, 0] + 1):
                        for cy in range(c0[i, 1], c1[i, 1] + 1):
                            s, e = starts[cx * ny + cy], starts[cx * ny + cy + 1]
                            if s == e:
                                continue
                            seg = band[s:e]
                            if np.any(
                                np.all((seg >= lo) & (seg <= hi), axis=1)
                            ):
                                hit = True
                                break
                        if hit:
                            break
                    hits[i] = hit
        # Reference counts out-of-bounds OR in-mesh, never both (continue).
        return int(np.sum(out_of_bounds | (~out_of_bounds & hits)))

    def _band_cell_grid(self, verts: np.ndarray, z_lo: float, z_hi: float,
                        r: float):
        """CSR (x, y) cell index over the z-band vertices, cached per band.

        Candidates share the robot height, so every recount in a room hits
        the same band; building the index once (a sort) and slicing cells
        per waypoint replaces 37 candidates x W waypoints full-band scans.
        """
        key = (round(float(z_lo), 6), round(float(z_hi), 6), len(verts))
        cached = getattr(self, "_band_grid_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        band = verts[(verts[:, 2] >= z_lo) & (verts[:, 2] <= z_hi)]
        if not len(band):
            grid = None
        else:
            cell = max(2.0 * r, 1e-3)
            inv_h = 1.0 / cell
            lo0 = band[:, :2].min(axis=0)
            cx = np.floor((band[:, 0] - lo0[0]) * inv_h).astype(np.int64)
            cy = np.floor((band[:, 1] - lo0[1]) * inv_h).astype(np.int64)
            nx, ny = int(cx.max()) + 1, int(cy.max()) + 1
            cid = cx * ny + cy
            order = np.argsort(cid, kind="stable")
            band = np.ascontiguousarray(band[order])
            starts = np.searchsorted(cid[order], np.arange(nx * ny + 1))
            grid = (band, starts, lo0, inv_h, nx, ny)
        self._band_grid_cache = (key, grid)
        return grid

    @staticmethod
    def _generate_linear_waypoints(
        start_point: np.ndarray, end_point: np.ndarray, num_waypoints: int
    ) -> List[Waypoint]:
        """Straight-line interpolation (reference: :390-402)."""
        waypoints = []
        for i in range(num_waypoints):
            t = i / (num_waypoints - 1) if num_waypoints > 1 else 0
            p = start_point + t * (end_point - start_point)
            waypoints.append(Waypoint(x=p[0], y=p[1], z=p[2], yaw=0))
        return waypoints

    @staticmethod
    def _find_nearest_free_space_point(
        point: np.ndarray, free_space_points: List[np.ndarray]
    ) -> Optional[int]:
        if not free_space_points:
            return None
        pts = np.asarray(free_space_points)
        return int(np.argmin(np.linalg.norm(pts - point, axis=1)))

    def _a_star_search(
        self, start_idx: int, end_idx: int, free_space_points: List[np.ndarray]
    ) -> Optional[List[int]]:
        """Heap-based A* over the connectivity graph (reference: :413-473)."""
        if start_idx == end_idx:
            return [start_idx]
        graph = self.room_analysis.connectivity_graph
        pts = np.asarray(free_space_points)

        def heuristic(i, j):
            return float(np.linalg.norm(pts[i] - pts[j]))

        g_score = {start_idx: 0.0}
        came_from: Dict[int, int] = {}
        open_heap = [(heuristic(start_idx, end_idx), start_idx)]
        closed = set()
        while open_heap:
            _, current = heapq.heappop(open_heap)
            if current == end_idx:
                path = [current]
                while current in came_from:
                    current = came_from[current]
                    path.append(current)
                return path[::-1]
            if current in closed:
                continue
            closed.add(current)
            for neighbor in graph.get(current, []):
                if neighbor in closed:
                    continue
                tentative_g = g_score[current] + heuristic(current, neighbor)
                if tentative_g < g_score.get(neighbor, float("inf")):
                    came_from[neighbor] = current
                    g_score[neighbor] = tentative_g
                    heapq.heappush(
                        open_heap, (tentative_g + heuristic(neighbor, end_idx), neighbor)
                    )
        return None

    @staticmethod
    def _generate_waypoints_along_path(
        path_points: List[np.ndarray], num_waypoints: int
    ) -> List[Waypoint]:
        """Arc-length-proportional resampling (reference: :475-527)."""
        if len(path_points) < 2:
            return []
        path = np.asarray(path_points, dtype=np.float64)
        seg_lengths = np.linalg.norm(np.diff(path, axis=0), axis=1)
        total_length = float(seg_lengths.sum())
        if total_length < 1e-6:
            p = path[0]
            return [Waypoint(x=p[0], y=p[1], z=p[2], yaw=0)]
        cum = np.concatenate([[0.0], np.cumsum(seg_lengths)])
        waypoints = []
        for i in range(num_waypoints):
            if i == num_waypoints - 1:
                p = path[-1]
            else:
                target = (i / (num_waypoints - 1)) * total_length
                seg = int(np.clip(np.searchsorted(cum, target, "right") - 1, 0,
                                  len(seg_lengths) - 1))
                seg_len = seg_lengths[seg]
                progress = (target - cum[seg]) / seg_len if seg_len > 0 else 0
                p = path[seg] + progress * (path[seg + 1] - path[seg])
            waypoints.append(Waypoint(x=p[0], y=p[1], z=p[2], yaw=0))
        return waypoints

    @staticmethod
    def _smooth_trajectory(
        waypoints: List[Waypoint], alpha: float = 0.5
    ) -> List[Waypoint]:
        """Moving-average smoothing, endpoints fixed (reference: :529-552)."""
        if len(waypoints) < 3:
            return waypoints
        smoothed = [waypoints[0]]
        for i in range(1, len(waypoints) - 1):
            prev, curr, nxt = waypoints[i - 1], waypoints[i], waypoints[i + 1]
            smoothed.append(
                Waypoint(
                    x=alpha * curr.x + (1 - alpha) * (prev.x + nxt.x) / 2,
                    y=alpha * curr.y + (1 - alpha) * (prev.y + nxt.y) / 2,
                    z=alpha * curr.z + (1 - alpha) * (prev.z + nxt.z) / 2,
                    yaw=curr.yaw,
                )
            )
        smoothed.append(waypoints[-1])
        return smoothed

    @staticmethod
    def _count_turns(waypoints: List[Waypoint]) -> int:
        """Direction changes above 30 degrees (reference: :554-588)."""
        if len(waypoints) < 3:
            return 0
        pts = np.array([[w.x, w.y] for w in waypoints])
        v = np.diff(pts, axis=0)
        norms = np.linalg.norm(v, axis=1)
        ok = (norms[:-1] > 1e-6) & (norms[1:] > 1e-6)
        v1 = v[:-1][ok] / norms[:-1][ok][:, None]
        v2 = v[1:][ok] / norms[1:][ok][:, None]
        ang = np.arccos(np.clip(np.sum(v1 * v2, axis=1), -1.0, 1.0))
        return int(np.sum(ang > np.pi / 6))

    @staticmethod
    def _calculate_trajectory_length(waypoints: List[Waypoint]) -> float:
        if len(waypoints) < 2:
            return 0.0
        pts = np.array([[w.x, w.y, w.z] for w in waypoints])
        return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())

    @staticmethod
    def _calculate_smoothness_score(waypoints: List[Waypoint]) -> float:
        """max(0, 1 - std(yaw changes)/pi) (reference: :608-628)."""
        if len(waypoints) < 3:
            return 1.0
        yaws = np.array([w.yaw for w in waypoints])
        changes = np.abs(np.diff(yaws))
        if len(changes) == 0:
            return 1.0
        return float(max(0.0, 1.0 - np.std(changes) / np.pi))

    def _select_best_trajectory(
        self, candidates: List[TrajectoryCandidate]
    ) -> TrajectoryCandidate:
        """0.4*length + 0.4*smoothness - 0.1*collisions (reference: :630-655)."""
        if not candidates:
            raise ValueError("No available trajectory candidates")
        min_length = self.min_trajectory_length
        best_candidate, best_score = None, -np.inf
        for candidate in candidates:
            length_score = min(candidate.length / min_length, 2.0)
            total_score = (
                length_score * 0.4
                + candidate.smoothness_score * 0.4
                - candidate.collision_count * 0.1
            )
            if total_score > best_score:
                best_score = total_score
                best_candidate = candidate
        return best_candidate

    def _generate_analysis_info(
        self,
        candidates: List[TrajectoryCandidate],
        best_candidate: TrajectoryCandidate,
    ) -> Dict[str, Any]:
        """Diagnostics JSON payload (reference: :657-691)."""
        if not candidates:
            return {}
        lengths = [c.length for c in candidates]
        collision_counts = [c.collision_count for c in candidates]
        smoothness_scores = [c.smoothness_score for c in candidates]
        return {
            "total_candidates": len(candidates),
            "best_trajectory": {
                "length": best_candidate.length,
                "collision_count": best_candidate.collision_count,
                "smoothness_score": best_candidate.smoothness_score,
                "start_point": best_candidate.start_point.tolist(),
                "end_point": best_candidate.end_point.tolist(),
            },
            "statistics": {
                "length_mean": float(np.mean(lengths)),
                "length_std": float(np.std(lengths)),
                "collision_mean": float(np.mean(collision_counts)),
                "collision_std": float(np.std(collision_counts)),
                "smoothness_mean": float(np.mean(smoothness_scores)),
                "smoothness_std": float(np.std(smoothness_scores)),
            },
            "room_analysis": {
                "free_space_points": len(self.room_analysis.free_space_points),
                "obstacle_points": len(self.room_analysis.obstacle_points),
                "room_dimensions": self.room_analysis.dimensions.tolist(),
                "room_center": self.room_analysis.center.tolist(),
            },
        }

    # ------------------------------------------------------------------
    def add_furniture(self, furniture: FurnitureInfo) -> None:
        self.collision_detector.add_furniture(furniture)

    def add_furniture_from_mesh(self, mesh, name: str, category: str = "unknown") -> None:
        self.collision_detector.add_furniture_from_mesh(mesh, name, category)

    def clear_furniture(self) -> None:
        self.collision_detector.clear_furniture()
