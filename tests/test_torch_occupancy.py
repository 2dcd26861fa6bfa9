"""Raycast occupancy (``ipcgen_tpu_torch/ops/occupancy.py``) against the JAX
package's ``ops/occupancy.py``, and a planner run with
``occupancy_mode: raycast`` through the port's simulator, on the CPU.

Tolerance: the port's default is the pair path, whose fp32 Pluecker edge
test may decide a ray that grazes an edge otherwise than the JAX package's
Moller-Trumbore backend; a cell is occupied when any of its 26 probe rays
hits, so the masks must agree on >= 99.9 % of the planning cells.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.ops.occupancy import obstacle_mask as jax_obstacle_mask  # noqa: E402
from ipcgen_tpu.ops.scene_asset import build_scene_asset as jax_build  # noqa: E402
from ipcgen_tpu_torch.containers import TriMesh  # noqa: E402
from ipcgen_tpu_torch.ops import occupancy  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset  # noqa: E402
from ipcgen_tpu_torch.trajectory import AutoTrajectoryGenerator  # noqa: E402
from ipcgen_tpu_torch.utils.synthetic import cluttered_room  # noqa: E402

AGREE = 0.999


def planning_cells(verts, res=0.2, z=1.0):
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    gx, gy = np.meshgrid(np.arange(lo[0], hi[0], res), np.arange(lo[1], hi[1], res),
                         indexing="ij")
    return np.stack([gx.ravel(), gy.ravel(), np.full(gx.size, z)], axis=1)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("backend", ["pairs", "culled", "brute"])
def test_obstacle_mask_matches_jax(seed, backend):
    verts, tris = cluttered_room(np.random.default_rng(seed), n_boxes=6)
    cells = planning_cells(verts)
    want = jax_obstacle_mask(jax_build(verts, tris), cells, 0.15)
    got = occupancy.obstacle_mask(build_scene_asset(verts, tris, device="cpu"), cells,
                                  0.15, backend=backend)
    assert got.dtype == bool and got.shape == (len(cells),)
    assert 0 < want.sum() < len(cells)
    assert np.mean(got == want) >= AGREE, np.mean(got == want)


def test_probe_directions_match_jax():
    from ipcgen_tpu.ops.occupancy import _probe_directions

    np.testing.assert_array_equal(occupancy._probe_directions(), _probe_directions())


def test_obstacle_mask_box_room():
    room = TriMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)
    asset = build_scene_asset(room.vertices, room.triangles, block_size=8, device="cpu")
    cells = np.array([[2.0, 1.5, 1.25], [0.05, 1.5, 1.25], [3.9, 1.5, 1.25],
                      [2.0, 1.5, 0.1], [2.0, 1.5, 0.5], [2.0, 0.05, 1.25]], np.float32)
    occ = occupancy.obstacle_mask(asset, cells, robot_radius=0.15)
    np.testing.assert_array_equal(occ, [False, True, True, True, False, True])
    assert occupancy.obstacle_mask(asset, np.zeros((0, 3)), 0.15).shape == (0,)


def test_planner_raycast_mode_through_the_simulator(tmp_path, monkeypatch):
    """``trajectory.occupancy_mode: raycast`` reaches the port's planner with
    the simulator's resident asset; its grid is classified by probe rays and
    the plan equals the JAX planner's in the same mode."""
    from ipcgen_tpu.trajectory import AutoTrajectoryGenerator as JaxPlanner
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator

    verts, tris = cluttered_room(np.random.default_rng(3), n_boxes=4)
    mesh_path = tmp_path / "room.ply"
    TriMesh(vertices=verts, triangles=tris).save(mesh_path)
    calls = []
    real = occupancy.obstacle_mask
    monkeypatch.setattr(occupancy, "obstacle_mask",
                        lambda *a, **k: calls.append(len(a[1])) or real(*a, **k))
    sim = S3DISSimulator({"trajectory": {"occupancy_mode": "raycast"}, "seed": 0},
                         device="cpu")
    sim.load_scene(str(mesh_path))
    gen = sim.auto_trajectory_generator
    assert gen.occupancy_mode == "raycast" and gen.scene_asset is sim.scene_asset
    waypoints, info = sim.generate_auto_trajectory(num_waypoints=10)
    assert len(calls) == 1 and calls[0] > 100
    assert len(waypoints) >= 20 and info["room_analysis"]["free_space_points"] > 50

    jax_gen = JaxPlanner(robot_radius=0.15, seed=0, occupancy_mode="raycast",
                         scene_asset=jax_build(verts, tris))
    want, _ = jax_gen.generate_optimal_trajectory(
        sim.scene.room_mesh, sim.scene.room_bounds.to_dict(), num_waypoints=10)
    assert [(w.x, w.y, w.z, w.yaw) for w in waypoints] == [
        (w.x, w.y, w.z, w.yaw) for w in want]


def test_vertices_stays_the_default(tmp_path):
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator

    mesh_path = tmp_path / "box.ply"
    TriMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True).save(mesh_path)
    sim = S3DISSimulator({}, device="cpu")
    sim.load_scene(str(mesh_path))
    assert sim.auto_trajectory_generator.occupancy_mode == "vertices"
    assert isinstance(sim.auto_trajectory_generator, AutoTrajectoryGenerator)
