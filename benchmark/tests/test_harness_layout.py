"""The harness's data-driven layout, its import guard, the yardstick's
arithmetic, the room generator and the reference, on the CPU."""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import reference, rooms, roofline
from benchmark.guard import forbidden_loaded

from benchmark.tests.conftest import with_pipeline

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC = with_pipeline(json.loads((ROOT / "BENCHMARK.json").read_text()))


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda c: c["name"])
def test_each_cell_finds_its_files_by_name(cell):
    config = json.loads((BENCH / "configs" / f"{cell['config']}.json").read_text())
    assert config["name"] == cell["config"]
    assert (BENCH / "traffic" / f"{cell['traffic']}.json").is_file()
    assert hasattr(_load(BENCH / "entries" / f"{config['entry']}.py"), "Cell")
    listed = {c["name"]: c for c in SPEC["configs"]}[cell["config"]]
    assert listed["file"] == f"benchmark/configs/{cell['config']}.json"
    assert listed["reduced"] == config["reduced"]


@pytest.mark.parametrize("kind,folder,fn", [("end_to_end", "e2e", "value"),
                                            ("per_layer", "metrics", "read")])
def test_each_metric_has_its_module(kind, folder, fn):
    for m in SPEC[kind]:
        assert callable(getattr(_load(BENCH / folder / f"{m['name']}.py"), fn)), m["name"]


def test_benchmark_lists_only_what_its_cells_use():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    used = {c["config"] for c in spec["workloads"]}
    assert {c["name"] for c in spec["configs"]} == used
    cells = {c["name"] for c in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells, m["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    from benchmark.run import metrics_of

    for cell in SPEC["workloads"]:
        e2e = [m["name"] for m in metrics_of(SPEC, "end_to_end", cell["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = metrics_of(SPEC, "per_layer", cell["name"])
        assert layers and all(m["moves"] in e2e for m in layers)


def test_guard_compares_whole_top_level_names():
    assert forbidden_loaded(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen"]) == \
        ["flax", "jax", "jaxlib"]
    assert forbidden_loaded(["ipcgen_tpu", "ipcgen_tpu.ops.raycast"]) == ["ipcgen_tpu"]
    assert forbidden_loaded(["ipcgen_tpu_torch", "ipcgen_tpu_torch.sim.scan", "jaxtyping",
                             "numpy"]) == []


def test_harness_and_port_load_no_jax():
    code = ("import sys; import benchmark.run, benchmark.control, benchmark.reference; "
            "import ipcgen_tpu_torch.sim.simulator, ipcgen_tpu_torch.run_pipeline; "
            "from benchmark.guard import forbidden_loaded; print(forbidden_loaded())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, check=True).stdout.split()
    assert out[-1] == "[]"


def test_raycast_floor_by_hand():
    # 1,000 rays over 100 triangles: 100 x 36 + 1,000 x 32 = 35,600 bytes;
    # 1,000 tests of 56 operations.
    f = roofline.raycast_floor_s(1000, 100)
    assert roofline.MT_FLOPS == 56
    assert f["bytes"] == 35_600 and f["flops"] == 56_000
    assert f["seconds"] == pytest.approx(35_600 / 3.35e12)
    assert f["bound_by"] == "memory"
    g = roofline.raycast_floor_s(10**9, 1)
    assert g["bound_by"] == "memory"  # 56 flop over 32 B a ray: 1.75 flop/B, under the 20 of the peaks


def test_rooms_are_the_same_for_a_seed(tmp_path):
    a = rooms.make_pool(tmp_path / "a", 2**31 + 7, 1, 5_000, 0.002, 0.005, 0.5)
    b = rooms.make_pool(tmp_path / "b", 2**31 + 7, 1, 5_000, 0.002, 0.005, 0.5)
    c = rooms.make_pool(tmp_path / "c", 2**31 + 8, 1, 5_000, 0.002, 0.005, 0.5)
    for rel in ("tls_0/room.txt", "tls_0/Annotations/chair_1.txt", "mesh_0.ply"):
        assert (tmp_path / "a" / rel).read_bytes() == (tmp_path / "b" / rel).read_bytes()
        assert (tmp_path / "a" / rel).read_bytes() != (tmp_path / "c" / rel).read_bytes()
    assert a[0].room.boxes == b[0].room.boxes != c[0].room.boxes


def test_rows_parse_back_to_their_millimetres():
    mm = np.array([[0, 1, -1], [-500, 1234, 99999], [-1750, 7750, -12]])
    rgb = np.array([[0, 5, 255], [10, 100, 99], [1, 2, 3]])
    got = np.loadtxt(rooms.row_bytes(mm, rgb).tobytes().decode().splitlines())
    assert np.array_equal(np.rint(got[:, :3] * 1000).astype(int), mm)
    assert np.array_equal(got[:, 3:].astype(int), rgb)


@pytest.mark.parametrize("voxel", [0.5, 0.03])
def test_recon_mesh_lies_on_the_base_surface_and_covers_it(voxel):
    room = rooms.Room.draw(rooms.room_rng(3, 0))
    v, t = room.recon_mesh(voxel)
    c = v[t].astype(np.float64)
    cross = np.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0])
    area = np.linalg.norm(cross, axis=1) / 2
    base = room.base_triangles()
    base_area = np.linalg.norm(np.cross(base[:, 1] - base[:, 0], base[:, 2] - base[:, 0]),
                               axis=1).sum() / 2
    assert area.min() > 0 and area.sum() == pytest.approx(base_area, rel=1e-6)
    # Each corner lies on an axis plane of the room or of a box face,
    # within float32's rounding.
    planes = [set(np.round(base[..., a].ravel(), 6)) for a in range(3)]
    normal = np.argmax(np.abs(cross), axis=1)
    for a in range(3):
        rows = c[normal == a][:, :, a]
        on = np.isin(np.round(rows, 4), np.round(np.array(sorted(planes[a])), 4))
        assert on.all()
    if voxel == 0.03:  # the recon's count for such an office: about 1.4 M
        assert 1.3e6 < len(t) < 1.5e6


def test_recon_mesh_faces_into_the_room():
    room = rooms.Room([])
    v, t = room.recon_mesh(0.5)
    c = v[t].astype(np.float64)
    normals = np.cross(c[:, 1] - c[:, 0], c[:, 2] - c[:, 0])
    inward = np.asarray(rooms.ROOM_CENTER) - c.mean(1)
    assert np.all(np.einsum("tk,tk->t", normals, inward) > 0)


def test_planner_copy_gives_the_programs_waypoints(tmp_path):
    from ipcgen_tpu_torch.containers.mesh import TriMesh
    from ipcgen_tpu_torch.containers.scene import RoomBounds
    from ipcgen_tpu_torch.trajectory.auto import AutoTrajectoryGenerator
    from ipcgen_tpu_torch.trajectory.waypoint import waypoints_to_pose_batch

    from benchmark import planner

    for k in range(2):
        room = rooms.Room.draw(rooms.room_rng(2**31 + 9, k))
        rooms.write_mesh_ply(tmp_path / f"m{k}.ply", *room.recon_mesh(0.1))
        mesh = TriMesh.load(tmp_path / f"m{k}.ply")
        wps, _ = AutoTrajectoryGenerator(robot_radius=0.15, seed=0).generate_optimal_trajectory(
            mesh, RoomBounds.from_mesh(mesh).to_dict(), num_waypoints=20)
        verts, _ = reference.read_mesh(tmp_path / f"m{k}.ply")
        ours = planner.poses(planner.plan(verts, 20))
        assert len(ours) == 40 and np.array_equal(ours, waypoints_to_pose_batch(wps))


@pytest.mark.parametrize("kind", ["dual_axis", "grid"])
def test_ray_pattern_copy_gives_the_programs_rays(kind):
    from ipcgen_tpu_torch.models import beams

    if kind == "dual_axis":
        pattern = {"kind": kind, "rays": 64000, "num_lines": 32, "theta_min_deg": -20.0,
                   "theta_max_deg": 15.0, "swing_amplitude_deg": 5.0, "swing_frequency": 1.0}
        theirs, _ = beams.gen_dual_axis_dirs(torch.Generator().manual_seed(0), 64000, 32,
                                             np.radians(-20.0), np.radians(15.0),
                                             np.radians(5.0), 1.0, 0.0, 0.02, device="cpu")
    else:
        degrees = [round(15.0 - i * 35.0 / 31.0, 1) for i in range(32)]
        pattern = {"kind": kind, "horizontal_res": 64, "vertical_degrees": degrees}
        theirs = beams.gen_vertical_degree_dirs(degrees, 64, device="cpu")
    ours = reference.sensor_pattern(pattern)
    assert np.abs(ours - theirs.double().numpy()).max() < 1e-6
    # A point along a pattern ray from a moved and turned pose reads no gap.
    yaw, origin = 0.7, np.array([1.0, 2.0, 1.0])
    pose = np.eye(4)
    pose[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    pose[:3, 3] = origin
    d = ours[[5, 500]] @ pose[:3, :3].T
    gaps = reference.RayPattern(pattern).gaps(origin + 3.0 * d, np.stack([pose, pose]))
    assert gaps.max() < 1e-9


def test_twin_share_counts_rows_another_row_has():
    p = np.array([[0, 0, 0], [1, 2, 3], [1, 2, 3], [0.5, 0, 0], [1, 2, 3]], np.float32)
    assert reference.twin_share(p, "cpu") == pytest.approx(3 / 5)
    assert reference.twin_share(p[:2], "cpu") == 0.0


def test_first_hit_in_a_box_room():
    room = rooms.Room([])
    tris = room.base_triangles()
    o = np.array([[3.0, 2.5, 1.0], [3.0, 2.5, 1.0], [1.0, 1.0, 1.0]])
    d = np.array([[1.0, 0, 0], [0, 0, -1.0], [-1.0, -1.0, 0] / np.sqrt(2)])
    t = reference.first_hit(o, d, tris, "cpu")
    assert t == pytest.approx([3.0, 1.0, np.sqrt(2)])
    gaps = reference.hit_gaps(o + d * t[:, None], o, tris, "cpu")
    assert gaps.max() < 1e-12
    # A point in free space, or behind the first surface, is off.
    off = reference.hit_gaps(np.array([[5.0, 2.5, 1.0], [7.0, 2.5, 1.0]]), o[:2], tris, "cpu")
    assert np.all(off > 0.5)


def test_labels_of_the_nearest_points_and_ties():
    ref_pts = np.array([[0.0, 0, 0], [1.0, 0, 0], [0.5, 1.0, 0]])
    lab = reference.LabelReference(ref_pts, [2, 8, 7], [1, 1, 3])
    q = np.array([[0.1, 0, 0], [0.9, 0, 0], [0.5, 0, 0]])
    assert list(lab.wrong(q, [2, 8, 8], [1, 1, 1], 1e-9, k=3)) == [False, False, False]
    assert list(lab.wrong(q, [8, 2, 7], [1, 1, 3], 1e-9, k=3)) == [True, True, True]
    sem, ins = lab.labels(q[:2])
    assert list(sem) == [2, 8] and list(ins) == [1, 1]


def test_statistical_outliers_and_normals_of_a_plane():
    rng = np.random.default_rng(0)
    plane = np.c_[rng.uniform(0, 1, (2000, 2)), np.zeros(2000)]
    far = np.array([[0.5, 0.5, 3.0], [4.0, 4.0, 4.0]])
    keep = reference.stat_outlier_mask(np.vstack([plane, far]), 20, 2.0)
    assert keep[:2000].mean() > 0.95 and not keep[2000:].any()
    nrm = reference.pca_normals(plane, plane[:50], 0.1, 30)
    assert np.abs(nrm[:, 2]).min() > 0.999999


def test_read_ply_reads_the_generator_mesh(tmp_path):
    v = np.arange(9, dtype=np.float32).reshape(3, 3)
    rooms.write_mesh_ply(tmp_path / "m.ply", v, np.array([[0, 1, 2]], np.int32))
    verts, tris = reference.read_mesh(tmp_path / "m.ply")
    assert np.array_equal(verts, v) and tris.tolist() == [[0, 1, 2]]


def test_bfloat16_rounding_is_coarse():
    x = np.array([5.123456])
    assert abs(reference.round_to(x, torch.bfloat16)[0] - x[0]) > 1e-3
