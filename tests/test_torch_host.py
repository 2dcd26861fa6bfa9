"""The port's own host layer (copies of the JAX package's containers, io,
semantic, trajectory, config and native modules) against the JAX modules,
on the same seeded inputs: equal arrays, equal waypoints, byte-identical
files."""

import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ipcgen_tpu import config as jax_config  # noqa: E402
from ipcgen_tpu.containers import TriMesh as JaxTriMesh  # noqa: E402
from ipcgen_tpu.containers.scene import RoomBounds as JaxRoomBounds  # noqa: E402
from ipcgen_tpu.containers.sim_frame import S3DISSimFrame as JaxFrame  # noqa: E402
from ipcgen_tpu.io import ply as jax_ply  # noqa: E402
from ipcgen_tpu.semantic.annotations import S3DISAnnotationLoader as JaxLoader  # noqa: E402
from ipcgen_tpu.trajectory import AutoTrajectoryGenerator as JaxPlanner  # noqa: E402
from ipcgen_tpu.utils import native as jax_native  # noqa: E402
from ipcgen_tpu_torch import config  # noqa: E402
from ipcgen_tpu_torch.containers import TriMesh  # noqa: E402
from ipcgen_tpu_torch.containers.scene import RoomBounds  # noqa: E402
from ipcgen_tpu_torch.containers.sim_frame import S3DISSimFrame, ScanQuality  # noqa: E402
from ipcgen_tpu_torch.io import ply  # noqa: E402
from ipcgen_tpu_torch.semantic.annotations import S3DISAnnotationLoader  # noqa: E402
from ipcgen_tpu_torch.trajectory import AutoTrajectoryGenerator  # noqa: E402
from ipcgen_tpu_torch.utils import native  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "fixtures" / "golden_room"
ROOM = np.array([4.0, 3.0, 2.4])  # tests/fixtures/make_golden_room.py:19


def golden_box():
    return TriMesh.box(center=tuple(ROOM / 2), size=tuple(ROOM), inward=True)


@pytest.mark.parametrize("num_waypoints", [4, 20])
def test_auto_planner_waypoints_equal(num_waypoints):
    mesh = golden_box()
    bounds = RoomBounds.from_mesh(mesh).to_dict()
    assert bounds == JaxRoomBounds.from_mesh(mesh).to_dict()
    got, info = AutoTrajectoryGenerator(robot_radius=0.15, seed=0).generate_optimal_trajectory(
        mesh, bounds, num_waypoints=num_waypoints)
    want, jinfo = JaxPlanner(robot_radius=0.15, seed=0).generate_optimal_trajectory(
        mesh, bounds, num_waypoints=num_waypoints)
    assert [(w.x, w.y, w.z, w.yaw) for w in got] == [(w.x, w.y, w.z, w.yaw) for w in want]
    assert info == jinfo


@pytest.mark.parametrize("n", [0, 1, 10_007])
def test_labeled_ply_byte_identical(tmp_path, n):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8)
    sem = rng.integers(0, 13, n)
    ins = rng.integers(0, 40, n)
    ply.write_labeled_ply(tmp_path / "port.ply", pts, rgb, sem, ins)
    jax_ply.write_labeled_ply(tmp_path / "jax.ply", pts, rgb, sem, ins)
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "jax.ply").read_bytes()
    back = ply.read_labeled_ply(tmp_path / "port.ply")
    for got, want in zip(back, jax_ply.read_labeled_ply(tmp_path / "jax.ply")):
        np.testing.assert_array_equal(got, want)


def test_mesh_and_point_cloud_io_equal(tmp_path):
    mesh = golden_box()
    mesh.save(tmp_path / "m.ply")
    a, b = TriMesh.load(tmp_path / "m.ply"), JaxTriMesh.load(tmp_path / "m.ply")
    np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(a.triangles, b.triangles)
    pts = np.random.default_rng(1).random((500, 3)).astype(np.float32)
    ply.write_point_cloud(tmp_path / "p.ply", pts, colors=(pts * 255).astype(np.uint8))
    jax_ply.write_point_cloud(tmp_path / "q.ply", pts, colors=(pts * 255).astype(np.uint8))
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "q.ply").read_bytes()


def test_annotation_loader_arrays_equal():
    got_loader = S3DISAnnotationLoader(str(GOLDEN), verbose=False)
    want_loader = JaxLoader(str(GOLDEN), verbose=False)
    got_ann = got_loader.load_room_annotations("Area_1", "office_1")
    want_ann = want_loader.load_room_annotations("Area_1", "office_1")
    assert list(got_ann) == list(want_ann) and len(got_ann) > 5
    for k in got_ann:
        np.testing.assert_array_equal(got_ann[k], want_ann[k])
    got = got_loader.create_labeled_pointcloud_with_instances(got_ann)
    want = want_loader.create_labeled_pointcloud_with_instances(want_ann)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("tree", [
    {},
    {"simulation": {"backend": "pallas", "use_blk2go": True, "seed": 3}},
    {"data": {"data_root": "/data/s3dis", "area_name": "Area_2", "room_name": "lounge_1"},
     "simulation": {"robot_height": 1.2, "use_dense_lidar": True}},
])
def test_config_tree_equal(tree):
    got = config.PipelineConfig.from_dict(tree)
    want = jax_config.PipelineConfig.from_dict(tree)
    assert got.simulator_config() == want.simulator_config()
    assert got.to_dict() == want.to_dict()


def test_default_config_file_loads_equal():
    path = REPO / "configs" / "default_config.yaml"
    got = config.PipelineConfig.load(path)
    assert got.to_dict() == jax_config.PipelineConfig.load(path).to_dict()


def test_frame_dicts_cross_packages():
    """Frame pickles hold plain dicts: a port frame's pickle loads into the
    JAX class and back unchanged."""
    rng = np.random.default_rng(2)
    pts = rng.random((64, 3)).astype(np.float32)
    q = ScanQuality(coverage_ratio=0.5, num_points=64, incident_angle_mean=10.0,
                    incident_angle_std=2.0, scan_density=3.0, range_mean=2.0,
                    range_std=0.5, sensor_range_mean=1.5, sensor_range_std=0.2)
    frame = S3DISSimFrame(7, pts, rng.random(64).astype(np.float32), q)
    blob = pickle.dumps(frame.to_dict())
    jax_frame = JaxFrame.from_dict(pickle.loads(blob))
    back = S3DISSimFrame.from_dict(jax_frame.to_dict())
    np.testing.assert_array_equal(back.points, pts)
    assert back.frame_index == 7 and back.scan_quality.to_dict() == q.to_dict()


def test_native_library_in_the_ports_build_dir():
    """The port builds the repository's native runtime into its own build
    directory (never into ``native/``) and parses as the JAX binding does."""
    if not native.available():
        pytest.skip("no C++ compiler here: the port falls back to numpy")
    path = native._find_lib()
    assert path == REPO / "build" / "ipcgen_tpu_torch" / "libipcgen_native.so"
    table = GOLDEN / "Area_1" / "office_1" / "Annotations" / "chair_1.txt"
    np.testing.assert_array_equal(native.parse_float_table(str(table)),
                                  jax_native.parse_float_table(str(table)))
    pts = np.random.default_rng(3).random((1000, 3)).astype(np.float32)
    np.testing.assert_array_equal(native.morton_order(pts), jax_native.morton_order(pts))


def test_device_probe_reports_no_card_on_the_cpu():
    """The probe runs a product on the card in a subprocess; without a card
    it returns None, and the bounded wait gives up."""
    from ipcgen_tpu_torch.utils import device_probe

    assert device_probe.probe_device(timeout_s=120.0) is None
    assert device_probe.wait_for_device(max_wait_s=0.0, probe_timeout_s=120.0) is None
    assert device_probe.probe_device(timeout_s=0.001) is None  # a timeout is None too
