"""S3DIS simulation orchestration on one device.

Port of ``ipcgen_tpu/sim/simulator.py`` (:56-611, :703-946): load the mesh
and build the resident scene asset, plan the trajectory on the host, run the
fused multi-waypoint scan, build the frames and statistics, transfer labels
and write the artifacts; over a reconstruction directory, the batch entry
point ``main`` (skip and resume, an optional asynchronous export) and
``main_single``:

    python -m ipcgen_tpu_torch.sim.simulator

runs ``main()`` with its defaults.

The device is the card (``"cuda"``) unless the caller names another or the
config's ``raycast_engine.use_gpu`` is False, which asks for the CPU
(``resolve_device``); nothing falls back to another device or engine.

The raycast backend comes from the config's ``raycast_engine.backend``, in
the JAX package's names (``ops.raycast_backends.port_backend``): "mxu" runs
the candidate-pair kernel, "auto", "pallas" and "xla" the culled
Moller-Trumbore kernel (both compute the same function in the JAX package),
"xla_brute" the block-scan oracle.  ``ops/raycast_backends.py`` holds the
table and why "auto" is the culled kernel.

The trajectory planner's ``occupancy_mode`` comes from the config's
``trajectory`` section: "vertices" (the default) or "raycast", which probes
the planning grid through the resident scene asset (``ops/occupancy.py``).

``save_results(save_visualizations=True)``, the default wherever the JAX
package's is True, draws the trajectory, scan and scene figures
(``ipcgen_tpu_torch.viz``); matplotlib is imported at the first draw, so a
host without it (the GPU host) raises ``ImportError`` there.

Rooms in parallel: ``run_scenes_device_parallel`` puts rooms round-robin on
a list of devices, dispatching a wave's scans before collecting any, and
``main(room_dp=True)`` runs it over every card when there is more than one.
Within one room, ``raycast_engine.multichip`` with an initialised
``torch.distributed`` group of more than one rank shards the scan's rays over
the ranks (``parallel/shard.py``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ipcgen_tpu_torch.config import PipelineConfig
from ipcgen_tpu_torch.containers.mesh import TriMesh
from ipcgen_tpu_torch.containers.scene import RoomBounds, S3DISScene
from ipcgen_tpu_torch.containers.sim_frame import S3DISSimFrame, ScanQuality
from ipcgen_tpu_torch.containers.sim_scene import (
    LabelPrefetch,
    S3DISSimScene,
    claim_prewarmed_labels,
    prewarm_labels,
)
from ipcgen_tpu_torch.models.lidar_intrinsics import (
    DualAxisLidarIntrinsics,
    Indoor8LineLidarIntrinsics,
)
from ipcgen_tpu_torch.ops.raycast_backends import port_backend
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset, build_scene_asset, builds_on_card
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
from ipcgen_tpu_torch.utils.profiling import Recorder
from ipcgen_tpu_torch.viz import (
    MeshVisualizer,
    S3DISVisualizer,
    ScanResultVisualizer,
    TrajectoryVisualizer,
    create_visualization_summary,
)


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


def _span(name: str):
    """Run the method under the span ``name`` of the simulator's room
    recorder (``self.rec``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def method(self, *args, **kwargs):
            with self.rec.span(name):
                return fn(self, *args, **kwargs)
        return method
    return wrap


class S3DISSimulator:
    """Loads a scene, plans a trajectory, scans it and exports the results.

    ``device``: see ``resolve_device`` (None: the card, unless the config's
    ``raycast_engine.use_gpu`` is False).  ``rec`` records the room being
    simulated (``load_scene``, ``trajectory``, ``dispatch`` and
    ``collect_scan``'s spans); ``collect_scan`` hands it to the room's
    ``S3DISSimScene`` and starts a fresh one."""

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
        self.rec = Recorder()
        # The visualisers import matplotlib only when they draw.
        self.trajectory_visualizer = TrajectoryVisualizer()
        self.scan_visualizer = ScanResultVisualizer()
        self.mesh_visualizer = MeshVisualizer()
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
    @_span("load_scene")
    def load_scene(self, scene_path: str, scene_name: Optional[str] = None) -> S3DISScene:
        """Load the mesh (span ``mesh_read``), build the resident asset
        (span ``asset_build``; the counter ``asset_device_build`` is 1 where
        the card built it, 0 where the host did), start the label prefetch
        and set up the trajectory generators."""
        if scene_name is None:
            scene_name = Path(scene_path).stem
        self.rec.room = scene_name
        with self.rec.span("mesh_read"):
            mesh = TriMesh.load(scene_path)
            if mesh.num_vertices == 0:
                raise ValueError(f"Failed to load mesh file: {scene_path}")
            room_bounds = RoomBounds.from_mesh(mesh)
            self.scene = S3DISScene(scene_name, mesh, room_bounds=room_bounds)
        with self.rec.span("asset_build"):
            self.scene_asset = build_scene_asset(mesh.vertices, mesh.triangles,
                                                 device=self.device)
        self.rec.count("asset_device_build", float(builds_on_card(self.device)))
        root = self.config.get("s3dis_data_root")
        area, room = self.config.get("area"), self.config.get("room")
        # A batch run may have prewarmed this room's labels
        # (containers.sim_scene.prewarm_labels): claim that prefetch, else
        # start one now.
        self._label_prefetch = claim_prewarmed_labels(root, area, room,
                                                      device=self.device)
        if self._label_prefetch is None:
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

    @_span("trajectory")
    def generate_auto_trajectory(self, num_waypoints: int = 20):
        if self.auto_trajectory_generator is None or self.scene is None:
            raise ValueError("Scene not loaded. Call load_scene() first.")
        return self.auto_trajectory_generator.generate_optimal_trajectory(
            mesh=self.scene.room_mesh,
            room_bounds=self.scene.room_bounds.to_dict(),
            num_waypoints=num_waypoints,
        )

    def add_furniture(self, furniture_mesh, name: str, category: str = "unknown") -> None:
        """Register furniture for planning (reference: :169-179)."""
        self.collision_detector.add_furniture_from_mesh(furniture_mesh, name, category)

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
    @_span("dispatch")
    def dispatch_scan(self, waypoints: List[Waypoint], device=None):
        """Queue the fused multi-waypoint scan.

        With ``device`` the scene asset and the poses are committed to that
        device first, so that scans of several rooms dispatched on several
        cards run side by side (``run_scenes_device_parallel``).  A
        generator that lives elsewhere is replaced by one on ``device``
        seeded as it was, so its draws start again from the seed.  Without
        ``device``, ``raycast_engine.multichip`` and an initialised
        ``torch.distributed`` group of more than one rank shard the scan's
        rays over the ranks (``parallel.shard.scan_waypoints_sharded``).
        """
        if self.scene is None or self.scene_asset is None:
            raise ValueError("Scene not loaded. Call load_scene() first.")
        poses = waypoints_to_pose_batch(waypoints)
        noise = bool(self.config.get("apply_range_noise", False))
        multichip = (self.config.get("raycast_engine") or {}).get("multichip", False)
        if device is None and multichip and _world_size() > 1:
            from ipcgen_tpu_torch.parallel.shard import (
                make_device_mesh,
                scan_waypoints_sharded,
            )

            return scan_waypoints_sharded(
                self.scene_asset, self.lidar_config, poses, make_device_mesh(),
                generator=self.generator, backend=self.backend,
                apply_range_noise=noise, outputs="unordered",
            )
        if device is not None:
            device = as_device(device)
            if self.scene_asset.device != device:
                self.scene_asset = self.scene_asset.to(device)
            if self.generator.device != device:
                self.generator = torch.Generator(device=device).manual_seed(
                    self.generator.initial_seed())
            self.device = device
        return scan_waypoints(
            self.scene_asset, self.lidar_config, poses, generator=self.generator,
            apply_range_noise=noise,
            # collect_scan only mask-selects per waypoint, so the in-waypoint
            # ray order does not matter.
            outputs="unordered",
            backend=self.backend,
        )

    @_span("collect_scan")
    def collect_scan(self, batch, waypoints: List[Waypoint],
                     start_time: float) -> S3DISSimScene:
        """Wait for the scan, hand the room's recorder and its label
        transfer to a new ``S3DISSimScene``, and build the frames and
        per-frame statistics.  The counter ``label_prefetch_lead`` holds the
        seconds from the start of the room's label prefetch to the hand-off."""
        rec = self.rec
        total_points_per_scan = self.lidar_config.get_total_points_per_scan()
        room_volume = self.scene.room_bounds.get_volume()
        with rec.span("scan_exec"):
            sync(self.device)
        with rec.span("d2h"):
            all_points, all_mask = batch.points_and_mask()
        with rec.span("label_handoff"):
            if self._label_prefetch is not None:
                rec.count("label_prefetch_lead",
                          (time.time_ns() - self._label_prefetch.start_ns) / 1e9)
            sim_scene = S3DISSimScene(
                scene_name=self.scene.scene_name,
                simulation_config=self.config,
                mesh=self.scene.room_mesh,
                s3dis_data_root=self.config.get("s3dis_data_root", None),
                area=self.config.get("area", None),
                room=self.config.get("room", None),
                label_prefetch=self._label_prefetch,
                device=self.device,
                rec=rec,
            )
            self._label_prefetch = None
            self.rec = Recorder()
            sim_scene.scan_poses = waypoints_to_pose_batch(waypoints)
            sim_scene.set_device_label_queries(batch.points.reshape(-1, 3), all_mask)
            sim_scene.start_label_transfer_async()
        with rec.span("frame_build"):
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
        with rec.span("statistics"):
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
        return self.collect_scan(batch, waypoints, start_time)

    # ------------------------------------------------------------------
    def save_results(self, sim_scene: S3DISSimScene, output_dir: Path,
                     waypoints: Optional[List[Waypoint]] = None,
                     save_visualizations: bool = True) -> None:
        """Write the statistics, summaries and both combined clouds, and with
        ``save_visualizations`` the figures of ``output_dir/visualizations``
        (reference: :298-364).

        Where the JAX package swallows any error of the scene-level figures
        and their summary, this raises it, as every draw here does: without
        matplotlib that is ``ImportError``.
        """
        output_dir = Path(output_dir)
        sim_scene.save_results(output_dir)
        if not save_visualizations:
            return
        vis_dir = output_dir / "visualizations"
        vis_dir.mkdir(parents=True, exist_ok=True)
        self.trajectory_visualizer.output_dir = vis_dir
        self.scan_visualizer.output_dir = vis_dir
        self.mesh_visualizer.output_dir = vis_dir
        s3dis_visualizer = S3DISVisualizer(output_dir)
        if waypoints and self.scene:
            bounds = self.scene.room_bounds.to_dict()
            self.trajectory_visualizer.visualize_trajectory_2d(
                waypoints, bounds, title=f"Robot trajectory - {self.scene.scene_name}")
            self.trajectory_visualizer.visualize_trajectory_3d(
                waypoints, bounds, title=f"Robot trajectory 3D - {self.scene.scene_name}")
        self.scan_visualizer.visualize_scan_statistics(sim_scene)
        self.scan_visualizer.visualize_scan_quality_evolution(sim_scene)
        self.scan_visualizer.create_scan_summary_report(sim_scene)
        if self.scene:
            viz_results = s3dis_visualizer.generate_all_visualizations(
                sim_scene, self.scene, num_sample_frames=5)
            create_visualization_summary(viz_results, output_dir)

    def run_complete_simulation(
        self,
        scene_path: str,
        start_point,
        end_point,
        path_type: PathType = PathType.STRAIGHT,
        num_waypoints: int = 20,
        output_dir: Optional[Path] = None,
        scene_name: Optional[str] = None,
    ) -> S3DISSimScene:
        """Load -> manual trajectory -> scan -> save (reference: :366-405)."""
        self.load_scene(scene_path, scene_name)
        waypoints, _trajectory_quality = self.generate_trajectory(
            start_point, end_point, path_type, num_waypoints)
        sim_scene = self.run_simulation(waypoints)
        if output_dir is None:
            output_dir = Path("s3dis_simulation_results")
        self.save_results(sim_scene, output_dir, waypoints)
        return sim_scene

    def run_auto_simulation(self, scene_path: str, num_waypoints: int = 20,
                            output_dir: Optional[Path] = None,
                            scene_name: Optional[str] = None,
                            save_visualizations: bool = True,
                            save_executor: Optional[Any] = None) -> S3DISSimScene:
        """Load -> auto trajectory -> scan -> save.

        With ``save_executor`` (a ``concurrent.futures.Executor``) the export
        (label transfer join, PLY and statistics writing) is submitted to it
        and the pending future is attached as ``sim_scene.save_future``, so
        the caller can start the next scene's device work while this one's
        export drains.  Visualisations are off in that mode.
        """
        self.load_scene(scene_path, scene_name)
        waypoints, analysis_info = self.generate_auto_trajectory(num_waypoints)
        sim_scene = self.run_simulation(waypoints)
        output_dir = Path(output_dir or "s3dis_auto_simulation_results")

        def _save() -> None:
            with sim_scene.rec.span("save"):
                self.save_results(sim_scene, output_dir, waypoints,
                                  save_visualizations=save_visualizations
                                  and save_executor is None)
                with open(output_dir / "trajectory_analysis.json", "w",
                          encoding="utf-8") as f:
                    json.dump(analysis_info, f, indent=2, ensure_ascii=False)

        if save_executor is not None:
            with sim_scene.rec.span("export_submit"):
                sim_scene.save_future = save_executor.submit(_save)
        else:
            _save()
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
    save_visualizations: bool = True,
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
    ``save_visualizations`` draws the figures (``save_results``; off under
    ``save_executor``, as in the JAX package).  ``save_executor``
    takes the export of an auto-trajectory scene off the caller's thread
    (``S3DISSimulator.run_auto_simulation``).
    """
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
            save_executor=save_executor,
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


def _world_size() -> int:
    """Ranks of the default ``torch.distributed`` group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def run_scenes_device_parallel(
    scene_jobs: List[Dict[str, Any]],
    num_waypoints: int = 20,
    output_base_dir: str = "simulation_results",
    devices: Optional[List[Any]] = None,
    robot_height: float = 1.0,
    use_dense_lidar: bool = False,
    use_blk2go: bool = True,
    s3dis_data_root: str = "S3DIS/raw/S3DIS/data/Stanford3dDataset_v1.2_Aligned_Version",
    seed: int = 0,
    save_visualizations: bool = False,
    lidar_horizontal_res: Optional[int] = None,
) -> Tuple[List[Tuple[str, S3DISSimScene]], List[Tuple[str, str]]]:
    """Rooms in parallel, one room per device (reference: :614-700).

    Rooms go round-robin over ``devices`` (None: every card) in waves of
    ``len(devices)``.  Within a wave each room is loaded and planned on the
    host, its simulator built on its device, and its scan dispatched there;
    every scan of the wave is dispatched before the first is collected,
    exported and written.  Each room keeps its own simulator and seed, so
    its outputs equal those of the sequential driver on the same device.

    ``scene_jobs`` entries: ``{"scene_path", "scene_name", "area", "room"}``.
    Returns ``(successful [(name, sim_scene)], failed [(name, error)])``.
    """
    if devices is None:
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("run_scenes_device_parallel: no card; pass devices")
        devices = [torch.device("cuda", i) for i in range(n_cards)]
    successful: List[Tuple[str, S3DISSimScene]] = []
    failed: List[Tuple[str, str]] = []
    n_dev = max(len(devices), 1)
    for wave_start in range(0, len(scene_jobs), n_dev):
        wave = scene_jobs[wave_start:wave_start + n_dev]
        inflight = []
        for j, job in enumerate(wave):
            name = job["scene_name"]
            device = as_device(devices[j % n_dev])
            try:
                config = {
                    "raycast_engine": {"use_gpu": True},
                    "trajectory": {"robot_height": robot_height},
                    "s3dis_data_root": s3dis_data_root,
                    "area": job.get("area"),
                    "room": job.get("room"),
                    "seed": seed,
                    "lidar": {"horizontal_res": lidar_horizontal_res},
                }
                simulator = S3DISSimulator(config, use_dense_lidar=use_dense_lidar,
                                           use_blk2go=use_blk2go, device=device)
                t0 = time.time()
                simulator.load_scene(job["scene_path"], name)
                waypoints, analysis_info = simulator.generate_auto_trajectory(num_waypoints)
                batch = simulator.dispatch_scan(waypoints, device=device)
                inflight.append((name, simulator, waypoints, analysis_info, batch, t0))
                print(f"[RoomDP] {name} dispatched on {device}")
            except Exception as e:
                failed.append((name, str(e)))
                print(f"[RoomDP] {name} failed at dispatch: {e}")
        for name, simulator, waypoints, analysis_info, batch, t0 in inflight:
            try:
                sim_scene = simulator.collect_scan(batch, waypoints, t0)
                output_dir = Path(output_base_dir) / name
                simulator.save_results(sim_scene, output_dir, waypoints,
                                       save_visualizations=save_visualizations)
                with open(output_dir / "trajectory_analysis.json", "w",
                          encoding="utf-8") as f:
                    json.dump(analysis_info, f, indent=2, ensure_ascii=False)
                successful.append((name, sim_scene))
                print(f"[RoomDP] {name} completed.")
            except Exception as e:
                failed.append((name, str(e)))
                print(f"[RoomDP] {name} failed at collect/export: {e}")
    return successful, failed


def find_available_scenes(
    reconstruction_dir: str = "outputs/s3dis_reconstruction/reconstruction_results",
) -> List[Tuple[str, str, str]]:
    """Reconstructed scene meshes under ``reconstruction_dir``: one
    (mesh path, scene name, area_room) per scene directory holding a
    ``mesh_*.ply``, ``mesh_dense.ply`` preferred (reference: :556-591)."""
    reconstruction_path = Path(reconstruction_dir)
    if not reconstruction_path.exists():
        print(f"[Discovery] Reconstruction directory not found: {reconstruction_dir}")
        return []
    available_scenes = []
    for scene_dir in sorted(reconstruction_path.iterdir()):
        if scene_dir.is_dir():
            mesh_files = sorted(scene_dir.glob("mesh_*.ply"))
            if mesh_files:
                dense_mesh = scene_dir / "mesh_dense.ply"
                mesh_path = str(dense_mesh) if dense_mesh.exists() else str(mesh_files[0])
                scene_name = scene_dir.name
                available_scenes.append((mesh_path, scene_name, scene_name))
                print(f"[Discovery] Found scene {scene_name}: {mesh_path}")
    print(f"[Discovery] Total scenes discovered: {len(available_scenes)}")
    return available_scenes


def _parse_area_room(area_room: str) -> Tuple[str, str]:
    """(area, room) from a scene directory name (reference: :658-667)."""
    if "_" in area_room:
        parts = area_room.split("_")
        if len(parts) >= 3 and parts[0] == "Area":
            return f"{parts[0]}_{parts[1]}", "_".join(parts[2:])
        area, room = area_room.split("_", 1)
        return area, room
    return area_room, area_room


def _scenes_to_run(available_scenes, output_base_dir: str):
    """Skip and resume as the reference: a scene is skipped when both its
    labeled PLY and its statistics txt exist, and a partly written one runs
    again.  Returns (jobs, skipped names); a job is ``{"scene_path",
    "scene_name", "area", "room"}``."""
    jobs, skipped = [], []
    for scene_path, scene_name, area_room in available_scenes:
        scene_output_dir = Path(output_base_dir) / scene_name
        ply_file = scene_output_dir / "combined_pointcloud_with_label.ply"
        stats_file = scene_output_dir / "simulation_statistics.txt"
        if ply_file.exists() and stats_file.exists():
            print(f"[Batch] Scene {scene_name} already processed. Skipping.")
            skipped.append(scene_name)
            continue
        elif ply_file.exists() or stats_file.exists():
            print(f"[Batch] Scene {scene_name} partially processed. Re-running.")
        area, room = _parse_area_room(area_room)
        jobs.append({"scene_path": scene_path, "scene_name": scene_name,
                     "area": area, "room": room})
    return jobs, skipped


def _print_batch_summary(
    n_total: int, successful, skipped, failed, total_time: float
) -> None:
    print(f"[Batch] Total scenes: {n_total}")
    print(f"[Batch] Completed: {len(successful)}")
    print(f"[Batch] Skipped: {len(skipped)}")
    print(f"[Batch] Failed: {len(failed)}")
    print(f"[Batch] Total time: {total_time:.1f}s ({total_time / 60:.1f} min)")
    if n_total:
        print(f"[Batch] Average per scene: {total_time / n_total:.1f}s")
        rooms_per_hour = len(successful) / total_time * 3600 if total_time > 0 else 0
        print(f"[Batch] Throughput: {rooms_per_hour:.1f} rooms/hour")


class _DrainingExecutor:
    """``main``'s export queue over one export thread: ``submit`` first
    waits for the export in flight (``drain``), so exports run one at a time
    in room order, each while the next room loads and scans."""

    def __init__(self, executor, drain):
        self._executor, self._drain = executor, drain

    def submit(self, fn):
        self._drain()
        return self._executor.submit(fn)


def main(
    reconstruction_dir: str = "outputs/s3dis_reconstruction/reconstruction_results",
    num_waypoints: int = 20,
    output_base_dir: str = "simulation_results",
    use_gpu: bool = True,
    robot_height: float = 1.0,
    use_dense_lidar: bool = False,
    use_blk2go: bool = True,
    use_auto_trajectory: bool = True,
    s3dis_data_root: str = "S3DIS/raw/S3DIS/data/Stanford3dDataset_v1.2_Aligned_Version",
    async_export: bool = False,
    save_visualizations: bool = True,
    room_dp: bool = False,
    lidar_horizontal_res: Optional[int] = None,
    *,
    device=None,
) -> Dict[str, Any]:
    """Batch entry point over every reconstructed scene (reference:
    :594-726), each through ``run_single_scene_simulation`` on ``device``
    (None: the card; ``use_gpu=False`` asks for the CPU).

    The scenes to run are settled first, with the reference's skip and
    resume rules (``_scenes_to_run``).  The loop looks one room ahead: at
    the top of each room it waits for the previous room's label prefetch to
    end (that room's span ``label_prefetch_wait``), then prewarms the labels
    of this room and of the next (``containers.sim_scene.prewarm_labels``,
    claimed by ``load_scene``), so at most two rooms' labels are prefetched
    at once.  ``async_export=True`` runs the exports
    one at a time, in room order, on one background thread; a room's export
    runs while the next room loads, plans and scans, and ``main`` waits for
    it (the drained scene's span ``export_drain``) only before the next
    export is queued.  A scene whose load, scan or export raises counts as
    failed, and only that scene.  The outputs are those of
    ``async_export=False``.  When ``main`` returns, no prefetch it started is
    left running or unclaimed.

    ``room_dp=True`` with more than one card puts the rooms round-robin on
    every card (``run_scenes_device_parallel``); it raises ``ValueError``
    when ``device`` or ``use_gpu`` asks for the CPU.  With one card or none
    it runs the sequential path, as the JAX package does with one device.

    Returns {"successful": [(name, sim_scene)], "failed": [(name, error)],
    "skipped": [name], "total_time": seconds}.
    """
    print("=== S3DIS batch simulation ===")
    available_scenes = find_available_scenes(reconstruction_dir)
    if not available_scenes:
        print("[Batch] No scenes found. Verify the reconstruction directory.")
        return {"successful": [], "failed": [], "skipped": []}
    if room_dp and torch.cuda.device_count() > 1:
        if not use_gpu or (device is not None and torch.device(device).type != "cuda"):
            raise ValueError(
                f"room_dp spreads the rooms over every card, but use_gpu={use_gpu} "
                f"and device={device!r} ask for the CPU")
        start_time = time.time()
        jobs, skipped_scenes = _scenes_to_run(available_scenes, output_base_dir)
        successful_scenes, failed_scenes = run_scenes_device_parallel(
            jobs, num_waypoints=num_waypoints, output_base_dir=output_base_dir,
            robot_height=robot_height, use_dense_lidar=use_dense_lidar,
            use_blk2go=use_blk2go, s3dis_data_root=s3dis_data_root,
            save_visualizations=save_visualizations,
            lidar_horizontal_res=lidar_horizontal_res,
        )
        total_time = time.time() - start_time
        _print_batch_summary(len(available_scenes), successful_scenes, skipped_scenes,
                             failed_scenes, total_time)
        return {"successful": successful_scenes, "failed": failed_scenes,
                "skipped": skipped_scenes, "total_time": total_time}

    start_time = time.time()
    jobs, skipped_scenes = _scenes_to_run(available_scenes, output_base_dir)
    successful_scenes, failed_scenes = [], []
    pending: Optional[Tuple[str, S3DISSimScene]] = None

    def drain() -> None:
        """Wait for the export in flight (the scene's span
        ``export_drain``); its failure fails its scene."""
        nonlocal pending, successful_scenes
        if pending is None:
            return
        prev_name, prev_scene = pending
        pending = None
        try:
            with prev_scene.rec.span("export_drain"):
                prev_scene.save_future.result()
        except Exception as e:
            failed_scenes.append((prev_name, str(e)))
            successful_scenes = [sc for sc in successful_scenes if sc[0] != prev_name]

    # The device load_scene claims the prewarmed labels on; where it cannot
    # be resolved, every scene fails on it below and nothing is prewarmed.
    try:
        label_device = resolve_device(device, use_gpu)
    except Exception:
        label_device = None
    prefetches: Dict[int, Optional[LabelPrefetch]] = {}  # job index -> its prewarm
    recorders: Dict[int, Recorder] = {}  # job index -> its scene's, once it ran

    def prewarm(k: int) -> None:
        if label_device is not None and k < len(jobs) and k not in prefetches:
            prefetches[k] = prewarm_labels(s3dis_data_root, jobs[k]["area"],
                                           jobs[k]["room"], device=label_device)

    def release(k: int) -> None:
        """Drop room k's prewarm if no ``load_scene`` claimed it, and wait
        for its thread (the span ``label_prefetch_wait`` of room k's scene)."""
        pf, rec = prefetches.pop(k), recorders.pop(k, None)
        if pf is None:
            return
        claim_prewarmed_labels(s3dis_data_root, jobs[k]["area"], jobs[k]["room"],
                               device=label_device)
        with rec.span("label_prefetch_wait") if rec else contextlib.nullcontext():
            pf.wait()

    executor = None
    save_executor = None
    if async_export:
        from concurrent.futures import ThreadPoolExecutor

        executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="export")
        save_executor = _DrainingExecutor(executor, drain)

    try:
        for i, job in enumerate(jobs):
            if i - 1 in prefetches:
                release(i - 1)
            prewarm(i)
            prewarm(i + 1)
            scene_name = job["scene_name"]
            print(f"[Batch] Processing scene {i + 1}/{len(jobs)}: {scene_name}")
            try:
                sim_scene = run_single_scene_simulation(
                    scene_path=job["scene_path"],
                    scene_name=scene_name,
                    num_waypoints=num_waypoints,
                    output_base_dir=output_base_dir,
                    use_gpu=use_gpu,
                    robot_height=robot_height,
                    use_dense_lidar=use_dense_lidar,
                    use_blk2go=use_blk2go,
                    use_auto_trajectory=use_auto_trajectory,
                    s3dis_data_root=s3dis_data_root,
                    area=job["area"],
                    room=job["room"],
                    save_visualizations=save_visualizations,
                    save_executor=save_executor,
                    lidar_horizontal_res=lidar_horizontal_res,
                    device=device,
                )
                successful_scenes.append((scene_name, sim_scene))
                recorders[i] = sim_scene.rec
                if getattr(sim_scene, "save_future", None) is not None:
                    pending = (scene_name, sim_scene)
                print(f"[Batch] Scene {scene_name} succeeded.")
            except Exception as e:
                failed_scenes.append((scene_name, str(e)))
                print(f"[Batch] Scene {scene_name} failed: {e}")
        drain()
    finally:
        if executor is not None:
            executor.shutdown(wait=True)
        for k in list(prefetches):
            release(k)

    total_time = time.time() - start_time
    _print_batch_summary(
        len(available_scenes), successful_scenes, skipped_scenes,
        failed_scenes, total_time,
    )
    return {
        "successful": successful_scenes,
        "failed": failed_scenes,
        "skipped": skipped_scenes,
        "total_time": total_time,
    }


def main_single(
    scene_path: str = (
        "outputs/s3dis_reconstruction/reconstruction_results/Area_1_office_1/"
        "mesh_dense.ply"
    ),
    scene_name: str = "Area_1_office_1",
    area: str = "Area_1",
    room: str = "office_1",
    num_waypoints: int = 20,
    **kwargs,
) -> S3DISSimScene:
    """One named scene (reference: :729-807); ``kwargs`` (``device`` among
    them) go to ``run_single_scene_simulation``."""
    sim_scene = run_single_scene_simulation(
        scene_path=scene_path,
        scene_name=scene_name,
        num_waypoints=num_waypoints,
        area=area,
        room=room,
        **kwargs,
    )
    print("[Single] Simulation completed.")
    if sim_scene and len(sim_scene.frames) > 0:
        total = sum(len(f.points) for f in sim_scene.frames)
        print(f"Frames: {len(sim_scene.frames)}")
        print(f"Total points: {total:,}")
        print(f"Average points per frame: {total // len(sim_scene.frames):,}")
    return sim_scene


if __name__ == "__main__":
    main()
