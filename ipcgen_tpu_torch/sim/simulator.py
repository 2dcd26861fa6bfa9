"""S3DIS simulation orchestration on one device.

Port of ``ipcgen_tpu/sim/simulator.py`` (:56-489, :509-611): load the mesh
and build the resident scene asset, plan the trajectory on the host, run the
fused multi-waypoint scan, build the frames and statistics, transfer labels
and write the artifacts.  The device is the card (``"cuda"``) unless the
caller names another or the config's ``raycast_engine.use_gpu`` is False,
which asks for the CPU (``resolve_device``); nothing falls back to another
device or engine.

The raycast backend comes from the config's ``raycast_engine.backend``, in
the JAX package's names (``port_backend``): "auto" and "mxu" run the
candidate-pair kernel, "pallas" and "xla" the culled Moller-Trumbore kernel
(both compute the same function in the JAX package), "xla_brute" the block-
scan oracle.  "auto" does not copy the JAX package's "xla off the TPU" rule:
the tensors' device picks the kernel or its plain version.

The trajectory planner's ``occupancy_mode`` comes from the config's
``trajectory`` section: "vertices" (the default) or "raycast", which probes
the planning grid through the resident scene asset (``ops/occupancy.py``).

Not ported yet (see ROADMAP.md): visualisations, multi-device room
parallelism, the shard-level raycast paths, and the batch entry points
``main``/``main_single`` with ``find_available_scenes``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ipcgen_tpu_torch.config import PipelineConfig
from ipcgen_tpu_torch.containers.mesh import TriMesh
from ipcgen_tpu_torch.containers.scene import RoomBounds, S3DISScene
from ipcgen_tpu_torch.containers.sim_frame import S3DISSimFrame, ScanQuality
from ipcgen_tpu_torch.containers.sim_scene import LabelPrefetch, S3DISSimScene
from ipcgen_tpu_torch.models.lidar_intrinsics import (
    DualAxisLidarIntrinsics,
    Indoor8LineLidarIntrinsics,
)
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset, build_scene_asset
from ipcgen_tpu_torch.sim.scan import scan_waypoints
from ipcgen_tpu_torch.trajectory import (
    AutoTrajectoryGenerator,
    CollisionDetector,
    PathType,
    SmartTrajectoryGenerator,
    Waypoint,
)
from ipcgen_tpu_torch.trajectory.waypoint import waypoints_to_pose_batch
from ipcgen_tpu_torch.utils.device import as_device, sync

# The JAX package's raycast backend names -> the port's backends.
RAYCAST_BACKENDS = {
    "auto": "pairs",
    "mxu": "pairs",
    "pallas": "culled",
    "xla": "culled",
    "xla_brute": "brute",
}


def port_backend(name: str) -> str:
    """The port's raycast backend for a JAX backend name; raises on an
    unknown name."""
    try:
        return RAYCAST_BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown raycast backend {name!r}; expected one of "
            f"{', '.join(map(repr, RAYCAST_BACKENDS))}") from None


def resolve_device(device, use_gpu: bool) -> torch.device:
    """The device a simulation runs on.  With ``use_gpu`` (the config's
    ``raycast_engine.use_gpu``), ``device``, or the card ("cuda") when it is
    None.  ``use_gpu=False`` asks for the CPU: the CPU, and a ``device`` other
    than the CPU raises.  Where the JAX package drops to its CPU engine when
    the TPU one fails, nothing here falls back."""
    if use_gpu:
        return as_device("cuda" if device is None else device)
    if device is not None and torch.device(device).type != "cpu":
        raise ValueError(f"use_gpu=False asks for the CPU, but device={device!r} was given")
    return torch.device("cpu")


class S3DISSimulator:
    """Loads a scene, plans a trajectory, scans it and exports the results.

    ``device``: see ``resolve_device`` (None: the card, unless the config's
    ``raycast_engine.use_gpu`` is False)."""

    def __init__(
        self,
        config: Dict[str, Any],
        use_dense_lidar: bool = False,
        use_blk2go: bool = False,
        device=None,
    ):
        self.config = config
        self.use_dense_lidar = use_dense_lidar
        self.use_blk2go = use_blk2go
        self.device = resolve_device(
            device, (config.get("raycast_engine") or {}).get("use_gpu", True))
        self.backend = port_backend(
            (config.get("raycast_engine") or {}).get("backend", "auto"))
        self.scene: Optional[S3DISScene] = None
        self.scene_asset: Optional[SceneAsset] = None
        self.trajectory_generator: Optional[SmartTrajectoryGenerator] = None
        self.auto_trajectory_generator: Optional[AutoTrajectoryGenerator] = None
        self.generator = torch.Generator(device=self.device).manual_seed(
            int(config.get("seed", 0) or 0))
        self._label_prefetch: Optional[LabelPrefetch] = None
        self._initialize_components()

    def _initialize_components(self) -> None:
        if self.use_blk2go:
            self.lidar_config = DualAxisLidarIntrinsics.create_blk2go_dual_axis()
        elif self.use_dense_lidar:
            self.lidar_config = Indoor8LineLidarIntrinsics.create_dense_32line()
        else:
            self.lidar_config = Indoor8LineLidarIntrinsics.create_standard_8line()
        hres = (self.config.get("lidar", {}) or {}).get("horizontal_res")
        if hres and hasattr(self.lidar_config, "horizontal_res"):
            self.lidar_config.horizontal_res = int(hres)
        self.collision_detector = CollisionDetector()

    # ------------------------------------------------------------------
    def load_scene(self, scene_path: str, scene_name: Optional[str] = None) -> S3DISScene:
        """Load the mesh, build the resident asset, start the label prefetch
        and set up the trajectory generators."""
        mesh = TriMesh.load(scene_path)
        if mesh.num_vertices == 0:
            raise ValueError(f"Failed to load mesh file: {scene_path}")
        room_bounds = RoomBounds.from_mesh(mesh)
        if scene_name is None:
            scene_name = Path(scene_path).stem
        self.scene = S3DISScene(scene_name, mesh, room_bounds=room_bounds)
        self.scene_asset = build_scene_asset(mesh.vertices, mesh.triangles,
                                             device=self.device)
        root = self.config.get("s3dis_data_root")
        area, room = self.config.get("area"), self.config.get("room")
        self._label_prefetch = (
            LabelPrefetch(root, area, room, device=self.device)
            if root and area and room else None
        )
        traj = self.config.get("trajectory", {}) or {}
        self.trajectory_generator = SmartTrajectoryGenerator(
            room_bounds.to_dict(), robot_height=traj.get("robot_height", 1.0))
        # "raycast" classifies the planning grid with probe rays against the
        # resident asset (ops/occupancy.py); "vertices" is the default.
        self.auto_trajectory_generator = AutoTrajectoryGenerator(
            robot_radius=0.15, seed=self.config.get("seed"),
            occupancy_mode=traj.get("occupancy_mode", "vertices"),
            scene_asset=self.scene_asset,
        )
        return self.scene

    def generate_auto_trajectory(self, num_waypoints: int = 20):
        if self.auto_trajectory_generator is None or self.scene is None:
            raise ValueError("Scene not loaded. Call load_scene() first.")
        return self.auto_trajectory_generator.generate_optimal_trajectory(
            mesh=self.scene.room_mesh,
            room_bounds=self.scene.room_bounds.to_dict(),
            num_waypoints=num_waypoints,
        )

    def generate_trajectory(self, start_point, end_point,
                            path_type: PathType = PathType.STRAIGHT,
                            num_waypoints: int = 20):
        """Manual trajectory between two points."""
        if self.trajectory_generator is None:
            raise ValueError("Scene not loaded. Call load_scene() first.")
        if self.collision_detector.furniture_list:
            self.trajectory_generator.collision_detector = self.collision_detector
        waypoints, quality = self.trajectory_generator.generate_trajectory(
            start_point=start_point, end_point=end_point, path_type=path_type,
            num_waypoints=num_waypoints,
        )
        return waypoints, quality.to_dict()

    # ------------------------------------------------------------------
    def dispatch_scan(self, waypoints: List[Waypoint]):
        """Queue the fused multi-waypoint scan on the device."""
        if self.scene is None or self.scene_asset is None:
            raise ValueError("Scene not loaded. Call load_scene() first.")
        return scan_waypoints(
            self.scene_asset, self.lidar_config,
            waypoints_to_pose_batch(waypoints), generator=self.generator,
            apply_range_noise=bool(self.config.get("apply_range_noise", False)),
            # collect_scan only mask-selects per waypoint, so the in-waypoint
            # ray order does not matter.
            outputs="unordered",
            backend=self.backend,
        )

    def collect_scan(self, batch, waypoints: List[Waypoint],
                     start_time: float) -> S3DISSimScene:
        """Wait for the scan, build the frames and per-frame statistics, and
        start the label transfer."""
        sim_scene = S3DISSimScene(
            scene_name=self.scene.scene_name,
            simulation_config=self.config,
            mesh=self.scene.room_mesh,
            s3dis_data_root=self.config.get("s3dis_data_root", None),
            area=self.config.get("area", None),
            room=self.config.get("room", None),
            label_prefetch=self._label_prefetch,
            device=self.device,
        )
        self._label_prefetch = None
        total_points_per_scan = self.lidar_config.get_total_points_per_scan()
        room_volume = self.scene.room_bounds.get_volume()
        t0 = time.time()
        sync(self.device)
        sim_scene.profile["scan_exec"] = time.time() - t0
        t0 = time.time()
        all_points, all_mask = batch.points_and_mask()
        sim_scene.profile["d2h"] = time.time() - t0
        sim_scene.scan_poses = waypoints_to_pose_batch(waypoints)
        sim_scene.set_device_label_queries(batch.points.reshape(-1, 3), all_mask)
        sim_scene.start_label_transfer_async()
        t0 = time.time()
        origins = np.stack([w.to_pose_matrix()[:3, 3] for w in waypoints])
        for i in range(len(waypoints)):
            points = all_points[i][all_mask[i]]
            rel = points - origins[i][None, :]
            sensor_ranges = np.linalg.norm(rel, axis=1)
            safe = np.maximum(sensor_ranges, 1e-12)
            incident_angles = np.degrees(
                np.arccos(np.clip(np.abs(rel[:, 2]) / safe, 0.0, 1.0)))
            # Range stats are norms of world positions (reference formula);
            # the sensor ranges are reported beside them.
            ranges = np.linalg.norm(points, axis=1) if len(points) else np.zeros(0)
            has = len(points) > 0
            scan_quality = ScanQuality(
                coverage_ratio=len(points) / total_points_per_scan,
                num_points=len(points),
                incident_angle_mean=float(np.mean(incident_angles)) if has else 0,
                incident_angle_std=float(np.std(incident_angles)) if has else 0,
                scan_density=len(points) / room_volume,
                range_mean=float(np.mean(ranges)) if has else 0,
                range_std=float(np.std(ranges)) if has else 0,
                sensor_range_mean=float(np.mean(sensor_ranges)) if has else 0.0,
                sensor_range_std=float(np.std(sensor_ranges)) if has else 0.0,
            )
            sim_scene.append_frame(
                S3DISSimFrame(i, points, incident_angles, scan_quality))
        sim_scene.profile["frame_build"] = time.time() - t0
        simulation_time = time.time() - start_time
        sim_scene.compute_statistics(simulation_time)
        total_rays = int(all_mask.size)
        if simulation_time > 0:
            print(
                f"[Perf] {total_rays:,} rays / {simulation_time:.3f}s = "
                f"{total_rays / simulation_time / 1e6:.1f} M rays/s "
                f"({len(waypoints)} waypoints, device={self.device})"
            )
        return sim_scene

    def run_simulation(self, waypoints: List[Waypoint]) -> S3DISSimScene:
        start_time = time.time()
        batch = self.dispatch_scan(waypoints)
        dispatch_s = time.time() - start_time
        scene = self.collect_scan(batch, waypoints, start_time)
        scene.profile["dispatch"] = dispatch_s
        return scene

    # ------------------------------------------------------------------
    def save_results(self, sim_scene: S3DISSimScene, output_dir: Path,
                     waypoints: Optional[List[Waypoint]] = None,
                     save_visualizations: bool = False) -> None:
        """Write the statistics, summaries and both combined clouds."""
        if save_visualizations:
            raise NotImplementedError("visualisations are not ported yet")
        output_dir = Path(output_dir)
        sim_scene.save_results(output_dir)

    def run_auto_simulation(self, scene_path: str, num_waypoints: int = 20,
                            output_dir: Optional[Path] = None,
                            scene_name: Optional[str] = None,
                            save_visualizations: bool = False) -> S3DISSimScene:
        """Load -> auto trajectory -> scan -> save."""
        t0 = time.time()
        self.load_scene(scene_path, scene_name)
        t1 = time.time()
        waypoints, analysis_info = self.generate_auto_trajectory(num_waypoints)
        t2 = time.time()
        sim_scene = self.run_simulation(waypoints)
        sim_scene.profile["load_scene"] = t1 - t0
        sim_scene.profile["trajectory"] = t2 - t1
        output_dir = Path(output_dir or "s3dis_auto_simulation_results")
        t3 = time.time()
        self.save_results(sim_scene, output_dir, waypoints,
                          save_visualizations=save_visualizations)
        with open(output_dir / "trajectory_analysis.json", "w",
                  encoding="utf-8") as f:
            json.dump(analysis_info, f, indent=2, ensure_ascii=False)
        sim_scene.profile["save"] = time.time() - t3
        return sim_scene


def load_config(config_path: str) -> Dict[str, Any]:
    """Load a YAML configuration file (yaml is imported here, at load)."""
    import yaml

    with open(config_path, "r", encoding="utf-8") as f:
        return yaml.safe_load(f)


def load_default_config() -> Dict[str, Any]:
    """The repository's ``configs/default_config.yaml``, or a minimal flat
    config when it is missing."""
    config_path = Path(__file__).resolve().parents[2] / "configs" / "default_config.yaml"
    if config_path.exists():
        return load_config(str(config_path))
    return {"raycast_engine": {"use_gpu": True}, "trajectory": {"robot_height": 1.0}}


def create_simulator_from_config(config_path: Optional[str] = None,
                                 device=None) -> S3DISSimulator:
    """Simulator on ``device`` (``resolve_device``) from a config file (the
    default config when None).

    Takes both the flat simulator dict and the typed ``PipelineConfig`` tree
    (``configs/default_config.yaml``); the tree goes through
    ``PipelineConfig.simulator_config()``.
    """
    config = load_default_config() if config_path is None else load_config(config_path)
    if "simulation" in config and "raycast_engine" not in config:
        tree = PipelineConfig.from_dict(config)
        return S3DISSimulator(
            tree.simulator_config(),
            use_dense_lidar=tree.simulation.use_dense_lidar,
            use_blk2go=tree.simulation.use_blk2go,
            device=device,
        )
    return S3DISSimulator(config, device=device)


def run_single_scene_simulation(
    scene_path: str,
    scene_name: Optional[str] = None,
    num_waypoints: int = 20,
    output_base_dir: str = "simulation_results",
    use_gpu: bool = True,
    robot_height: float = 1.0,
    use_dense_lidar: bool = False,
    use_blk2go: bool = True,
    enable_mesh_visualization: bool = False,
    use_auto_trajectory: bool = True,
    s3dis_data_root: str = "S3DIS/raw/S3DIS/data/Stanford3dDataset_v1.2_Aligned_Version",
    area: Optional[str] = None,
    room: Optional[str] = None,
    seed: int = 0,
    save_visualizations: bool = False,
    save_executor: Optional[Any] = None,
    lidar_horizontal_res: Optional[int] = None,
    *,
    device=None,
) -> S3DISSimScene:
    """Process one scene end to end (the sim stage).

    The JAX package's parameters in its order, then ``device``.  With
    ``use_gpu`` the scene runs on ``device`` (None: the card, "cuda");
    ``use_gpu=False`` asks for the CPU, and a ``device`` other than the CPU
    then raises (``resolve_device``; nothing falls back).
    ``save_visualizations`` defaults to False, not True as in the JAX
    package, because visualisations are not ported; ``save_executor`` (the
    asynchronous export) is not ported either and raises.
    """
    if save_executor is not None:
        raise NotImplementedError(
            "save_executor (the asynchronous export of run_auto_simulation) is not "
            "ported yet: ROADMAP.md, Queue 1 item 2")
    if scene_name is None:
        scene_name = Path(scene_path).parent.name
    output_dir = Path(output_base_dir) / scene_name
    config = {
        "raycast_engine": {"use_gpu": use_gpu},
        "trajectory": {"robot_height": robot_height},
        "enable_mesh_visualization": enable_mesh_visualization,
        "s3dis_data_root": s3dis_data_root,
        "area": area,
        "room": room,
        "seed": seed,
        "lidar": {"horizontal_res": lidar_horizontal_res},
    }
    simulator = S3DISSimulator(config, use_dense_lidar=use_dense_lidar,
                               use_blk2go=use_blk2go, device=device)
    if use_auto_trajectory:
        print(f"[Simulation] Using auto-generated trajectory for {scene_name}.")
        sim_scene = simulator.run_auto_simulation(
            scene_path=scene_path, num_waypoints=num_waypoints,
            output_dir=output_dir, scene_name=scene_name,
            save_visualizations=save_visualizations,
        )
    else:
        print(f"[Simulation] Using manual trajectory for {scene_name}.")
        simulator.load_scene(scene_path, scene_name)
        bounds = simulator.scene.room_bounds
        center = bounds.get_center()
        size = bounds.get_size()
        start_point = (center[0] - size[0] * 0.25, center[1], robot_height)
        end_point = (center[0] + size[0] * 0.25, center[1], robot_height)
        waypoints, _ = simulator.generate_trajectory(
            start_point, end_point, PathType.STRAIGHT, num_waypoints)
        sim_scene = simulator.run_simulation(waypoints)
        simulator.save_results(sim_scene, output_dir, waypoints,
                               save_visualizations=save_visualizations)
    print(f"[Simulation] Scene {scene_name} completed.")
    return sim_scene
