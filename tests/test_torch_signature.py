"""``run_single_scene_simulation`` takes the JAX package's parameters in the
JAX package's order, and ``use_gpu`` picks the device without a fallback.

The one documented difference: ``save_visualizations`` defaults to False in
the port (visualisations are not ported; the port raises where it would
draw) and True in the JAX package.  ``device`` is the port's own, and
keyword-only.
"""

import inspect
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.sim import simulator as jax_sim  # noqa: E402
from ipcgen_tpu_torch.containers.mesh import TriMesh  # noqa: E402
from ipcgen_tpu_torch.io.ply import read_labeled_ply  # noqa: E402
from ipcgen_tpu_torch.sim import simulator as port_sim  # noqa: E402

GOLDEN = Path(__file__).parent / "fixtures" / "golden_room"


def test_signature_matches_the_jax_package():
    jax_params = list(inspect.signature(jax_sim.run_single_scene_simulation).parameters.values())
    port_params = list(inspect.signature(port_sim.run_single_scene_simulation).parameters.values())
    assert [p.name for p in port_params] == [p.name for p in jax_params] + ["device"]
    assert port_params[-1].kind is inspect.Parameter.KEYWORD_ONLY
    assert all(p.kind is inspect.Parameter.POSITIONAL_OR_KEYWORD for p in port_params[:-1])
    differ = [p.name for p, q in zip(port_params, jax_params) if p.default != q.default]
    assert differ == ["save_visualizations"]
    assert jax_params[14].default is True and port_params[14].default is False


def test_use_gpu_false_with_a_cuda_device_raises():
    with pytest.raises(ValueError, match="use_gpu=False"):
        port_sim.run_single_scene_simulation("missing.ply", use_gpu=False, device="cuda")
    with pytest.raises(ValueError, match="use_gpu=False"):
        port_sim.S3DISSimulator({"raycast_engine": {"use_gpu": False}}, device="cuda:0")


def test_save_executor_raises_not_implemented():
    with pytest.raises(NotImplementedError, match="Queue 1 item 2"):
        port_sim.run_single_scene_simulation("missing.ply", save_executor=object())


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
