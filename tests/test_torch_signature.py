"""The port's entry points take the JAX package's parameters in the JAX
package's order, with the JAX package's defaults, and ``use_gpu`` picks the
device without a fallback.  ``device`` is the port's own, and keyword-only.
"""

import enum
import inspect
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.ops import grid_nn as jax_grid  # noqa: E402
from ipcgen_tpu.preprocess import loader as jax_loader  # noqa: E402
from ipcgen_tpu.sim import simulator as jax_sim  # noqa: E402
from ipcgen_tpu_torch.containers.mesh import TriMesh  # noqa: E402
from ipcgen_tpu_torch.io.ply import read_labeled_ply  # noqa: E402
from ipcgen_tpu_torch.ops import grid_nn as port_grid  # noqa: E402
from ipcgen_tpu_torch.preprocess import loader as port_loader  # noqa: E402
from ipcgen_tpu_torch.sim import simulator as port_sim  # noqa: E402

GOLDEN = Path(__file__).parent / "fixtures" / "golden_room"


def test_signature_matches_the_jax_package():
    jax_params = list(inspect.signature(jax_sim.run_single_scene_simulation).parameters.values())
    port_params = list(inspect.signature(port_sim.run_single_scene_simulation).parameters.values())
    assert [p.name for p in port_params] == [p.name for p in jax_params] + ["device"]
    assert port_params[-1].kind is inspect.Parameter.KEYWORD_ONLY
    assert all(p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD for p in port_params[:-1])
    differ = [p.name for p, q in zip(port_params, jax_params) if p.default != q.default]
    assert differ == []
    assert jax_params[14].name == "save_visualizations"
    assert jax_params[14].default is True and port_params[14].default is True


def test_use_gpu_false_with_a_cuda_device_raises():
    with pytest.raises(ValueError, match="use_gpu=False"):
        port_sim.run_single_scene_simulation("missing.ply", use_gpu=False, device="cuda")
    with pytest.raises(ValueError, match="use_gpu=False"):
        port_sim.S3DISSimulator({"raycast_engine": {"use_gpu": False}}, device="cuda:0")


def test_save_executor_raises_not_implemented(tmp_path):
    """The asynchronous export is ported: ``save_executor`` now runs the
    scene's export on the executor and attaches its future."""
    mesh_path = tmp_path / "mesh_dense.ply"
    TriMesh.box(center=(2.0, 1.5, 1.2), size=(4.0, 3.0, 2.4), inward=True).save(mesh_path)
    with ThreadPoolExecutor(max_workers=1) as executor:
        scene = port_sim.run_single_scene_simulation(
            str(mesh_path), scene_name="office_1", num_waypoints=3,
            output_base_dir=str(tmp_path), use_gpu=False, use_blk2go=False,
            s3dis_data_root=str(GOLDEN), area="Area_1", room="office_1",
            save_executor=executor, lidar_horizontal_res=100)
        scene.save_future.result()
    _, _, sem, _ = read_labeled_ply(tmp_path / "office_1" / "combined_pointcloud_with_label.ply")
    assert len(np.unique(sem)) > 3
    assert (tmp_path / "office_1" / "trajectory_analysis.json").is_file()


# (port function, JAX function, the port's extra keyword-only parameters, the
# parameters whose defaults differ: none).
ENTRY_POINTS = {
    "main": (port_sim.main, jax_sim.main, ["device"], []),
    "main_single": (port_sim.main_single, jax_sim.main_single, [], []),
    "run_complete_simulation": (port_sim.S3DISSimulator.run_complete_simulation,
                                jax_sim.S3DISSimulator.run_complete_simulation, [], []),
    "run_auto_simulation": (port_sim.S3DISSimulator.run_auto_simulation,
                            jax_sim.S3DISSimulator.run_auto_simulation, [], []),
    "save_results": (port_sim.S3DISSimulator.save_results,
                     jax_sim.S3DISSimulator.save_results, [], []),
    "dispatch_scan": (port_sim.S3DISSimulator.dispatch_scan,
                      jax_sim.S3DISSimulator.dispatch_scan, [], []),
    "run_scenes_device_parallel": (port_sim.run_scenes_device_parallel,
                                   jax_sim.run_scenes_device_parallel, [], []),
    "preprocess_room": (port_loader.preprocess_room, jax_loader.preprocess_room,
                        ["device"], []),
    "knn_grid": (port_grid.knn_grid, jax_grid.knn_grid, ["device"], []),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_signatures_match_the_jax_package(name):
    port_fn, jax_fn, extra, differ_want = ENTRY_POINTS[name]
    jax_params = list(inspect.signature(jax_fn).parameters.values())
    port_params = list(inspect.signature(port_fn).parameters.values())
    assert [p.name for p in port_params] == [p.name for p in jax_params] + extra
    assert [p.kind for p in port_params[:len(jax_params)]] == [p.kind for p in jax_params]
    assert all(p.kind is inspect.Parameter.KEYWORD_ONLY and p.default is None
               for p in port_params[len(jax_params):])
    # An enum default (PathType) is each package's own enum: compare values.
    value = lambda d: d.value if isinstance(d, enum.Enum) else d  # noqa: E731
    differ = [p.name for p, q in zip(port_params, jax_params)
              if value(p.default) != value(q.default)]
    assert differ == differ_want


@pytest.mark.parametrize("device,want", [(None, "cpu"), ("cpu", "cpu")])
def test_use_gpu_false_runs_on_the_cpu(device, want):
    assert port_sim.resolve_device(device, use_gpu=False) == torch.device(want)
    sim = port_sim.S3DISSimulator({"raycast_engine": {"use_gpu": False}}, device=device)
    assert sim.device == torch.device(want)


def test_jax_callers_keywords_run_on_the_cpu(tmp_path):
    """The keywords of scripts/run_pipeline.py:115-131 reach the port's
    function; ``use_gpu=False`` puts the whole scene on the CPU."""
    mesh_path = tmp_path / "mesh_dense.ply"
    TriMesh.box(center=(2.0, 1.5, 1.2), size=(4.0, 3.0, 2.4), inward=True).save(mesh_path)
    scene = port_sim.run_single_scene_simulation(
        scene_path=str(mesh_path), scene_name="office_1", num_waypoints=3,
        output_base_dir=str(tmp_path), use_gpu=False, robot_height=1.0,
        use_dense_lidar=False, use_blk2go=False, use_auto_trajectory=True,
        s3dis_data_root=str(GOLDEN), area="Area_1", room="office_1", seed=0,
        save_visualizations=False, lidar_horizontal_res=100)
    assert len(scene.frames) > 0 and all(len(f.points) for f in scene.frames)
    _, _, sem, _ = read_labeled_ply(tmp_path / "office_1" / "combined_pointcloud_with_label.ply")
    assert len(np.unique(sem)) > 3
