"""The whole sim stage: the port's ``run_single_scene_simulation`` against
the JAX package's, on a box mesh spanning the golden room with that room's
annotations as the TLS data.

Dense 32-line profile cut to 250 azimuth steps, 4 requested waypoints, seed
0: the scan has no randomness and the auto trajectory is the same host code,
so both runs scan the same rays.  Tolerances: the same frame count and
per-frame point counts within 0.5 % (the raycast contract allows rare
edge-tie differences); the labeled PLY header byte-identical; on rows joined
at 0.1 mm (as sim_scene.py:34-65 joins), >= 99 % of the port's rows matched
and their labels identical except on near-ties (within 0.5 mm) that the
JAX package's float32 exact 1-NN resolves inexactly (see the test).
When a comparison fails, its message holds both runs' planned waypoints
and per-frame point counts (``diagnosis``), so a failure shows whether the
runs planned different paths or scanned the same path differently.

The port configured with ``raycast_engine.backend: pallas`` (its culled
Moller-Trumbore path) is held to the same JAX run at the same tolerances:
off the TPU the JAX package's "auto" is its "xla" backend, the same
function as "pallas".
"""

from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

import jax  # noqa: E402
from ipcgen_tpu.containers import TriMesh  # noqa: E402
from ipcgen_tpu.containers.sim_scene import _exact_coord_join  # noqa: E402
from ipcgen_tpu.io.ply import read_labeled_ply  # noqa: E402

GOLDEN = Path(__file__).parent / "fixtures" / "golden_room"
ROOM = np.array([4.0, 3.0, 2.4])  # tests/fixtures/make_golden_room.py:19
KW = dict(scene_name="office_1", num_waypoints=4, use_dense_lidar=True,
          use_blk2go=False, s3dis_data_root=str(GOLDEN), area="Area_1",
          room="office_1", seed=0, save_visualizations=False,
          lidar_horizontal_res=250)
PLY = "combined_pointcloud_with_label.ply"


@contextmanager
def planned_waypoints(store: list):
    """Append each auto-planned trajectory, as (x, y, z, yaw) rows, to
    ``store``, from the JAX package's host planner or the port's copy."""
    from ipcgen_tpu.trajectory import AutoTrajectoryGenerator
    from ipcgen_tpu_torch.trajectory import AutoTrajectoryGenerator as PortGenerator

    def recorder(real):
        def record(self, *args, **kwargs):
            waypoints, info = real(self, *args, **kwargs)
            store.append([(w.x, w.y, w.z, w.yaw) for w in waypoints])
            return waypoints, info

        return record

    with pytest.MonkeyPatch.context() as mp:
        for cls in (AutoTrajectoryGenerator, PortGenerator):
            mp.setattr(cls, "generate_optimal_trajectory",
                       recorder(cls.generate_optimal_trajectory))
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from ipcgen_tpu.sim.simulator import run_single_scene_simulation as jax_run
    from ipcgen_tpu_torch.sim.simulator import run_single_scene_simulation as port_run

    root = tmp_path_factory.mktemp("slice")
    mesh_path = root / "mesh_dense.ply"
    TriMesh.box(center=tuple(ROOM / 2), size=tuple(ROOM), inward=True).save(mesh_path)
    jax_plan, port_plan = [], []
    with planned_waypoints(jax_plan):
        jax_scene = jax_run(str(mesh_path), output_base_dir=str(root / "jax"), **KW)
    with planned_waypoints(port_plan):
        port_scene = port_run(str(mesh_path), output_base_dir=str(root / "port"),
                              device="cpu", **KW)
    assert jax.default_backend() == "cpu"  # so the JAX run's "auto" is "xla"
    return dict(jax=jax_scene, port=port_scene, root=root,
                jax_dir=root / "jax" / "office_1", port_dir=root / "port" / "office_1",
                jax_plan=jax_plan, port_plan=port_plan)


@pytest.fixture(scope="module")
def culled_run(runs):
    """The port's run of the same scene with the culled backend, configured
    as a user would: ``raycast_engine.backend: pallas``."""
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator

    config = {
        "raycast_engine": {"backend": "pallas"},
        "trajectory": {"robot_height": 1.0}, "s3dis_data_root": str(GOLDEN),
        "area": "Area_1", "room": "office_1", "seed": 0,
        "lidar": {"horizontal_res": KW["lidar_horizontal_res"]},
    }
    sim = S3DISSimulator(config, use_dense_lidar=True, use_blk2go=False, device="cpu")
    assert sim.backend == "culled"
    out = runs["root"] / "culled" / "office_1"
    plan = []
    with planned_waypoints(plan):
        scene = sim.run_auto_simulation(str(runs["root"] / "mesh_dense.ply"),
                                        num_waypoints=KW["num_waypoints"],
                                        output_dir=out, scene_name="office_1")
    return dict(runs, port=scene, port_dir=out, port_plan=plan)


def diagnosis(runs) -> str:
    """Both runs' planned waypoints and per-frame point counts."""
    lines = []
    for side in ("jax", "port"):
        frames = runs[side].frames
        lines.append(f"{side} planned {np.round(runs[side + '_plan'], 6).tolist()}")
        lines.append(f"{side} points per frame {[len(f.points) for f in frames]}")
    return "\n".join(lines)


def check_frames(runs):
    jf, pf = runs["jax"].frames, runs["port"].frames
    assert len(pf) == len(jf) > 0, diagnosis(runs)
    for a, b in zip(jf, pf):
        na, nb = len(a.points), len(b.points)
        assert abs(na - nb) <= 0.005 * na, \
            f"frame {a.frame_index}: {na} vs {nb} points\n{diagnosis(runs)}"


def check_artifacts_and_statistics(runs):
    for name in ("combined_pointcloud.ply", PLY, "simulation_statistics.txt",
                 "simulation_summary.txt", "trajectory_analysis.json"):
        assert (runs["port_dir"] / name).is_file(), name
    # The statistics text agrees line for line, apart from the timings.
    def lines(d):
        return [ln for ln in (d / "simulation_statistics.txt").read_text().splitlines()
                if "time" not in ln.lower() and "per second" not in ln.lower()]

    assert lines(runs["port_dir"]) == lines(runs["jax_dir"]), diagnosis(runs)


def test_frames_match(runs):
    check_frames(runs)


def test_artifacts_and_statistics(runs):
    check_artifacts_and_statistics(runs)


def test_labeled_ply_matches(runs):
    check_labeled_ply(runs)


def test_culled_frames_match(culled_run):
    check_frames(culled_run)


def test_culled_artifacts_and_statistics(culled_run):
    check_artifacts_and_statistics(culled_run)


def test_culled_labeled_ply_matches(culled_run):
    check_labeled_ply(culled_run)


def check_labeled_ply(runs):
    pj, pp = runs["jax_dir"] / PLY, runs["port_dir"] / PLY
    head = lambda p: p.read_bytes().split(b"end_header")[0]
    assert head(pp) == head(pj)
    jx, jc, js, ji = read_labeled_ply(pj)
    px, pc, ps, pi = read_labeled_ply(pp)
    idx, matched = _exact_coord_join(px, jx)
    assert matched.mean() >= 0.99, f"{matched.mean()} joined\n{diagnosis(runs)}"
    rows = np.flatnonzero(matched)
    same = (ps[rows] == js[idx[rows]]) & (pi[rows] == ji[idx[rows]]) \
        & np.all(pc[rows] == jc[idx[rows]], axis=1)
    # A label may differ only on a near-tie that the JAX package resolves
    # inexactly: its exact 1-NN (the grid's residue path) uses the float32
    # norm expansion, which by its own account (ipcgen_tpu/ops/knn.py:159-165)
    # resolves near-ties within ~0.5 mm either way.  There the port must
    # hold the true nearest TLS point's labels.
    flips = rows[~same]
    assert len(flips) <= 1e-4 * len(rows), len(flips)
    if len(flips):
        from scipy.spatial import cKDTree

        from ipcgen_tpu.semantic.annotations import S3DISAnnotationLoader

        loader = S3DISAnnotationLoader(str(GOLDEN), verbose=False)
        refs, sem, ins = loader.create_labeled_pointcloud_with_instances(
            loader.load_room_annotations("Area_1", "office_1"))
        d, nn = cKDTree(refs).query(px[flips].astype(np.float64), k=2)
        assert np.all(d[:, 1] - d[:, 0] <= 5e-4), d
        for k, row in enumerate(flips):
            assert (ps[row], pi[row]) == (sem[nn[k, 0]], ins[nn[k, 0]])
            assert (js[idx[row]], ji[idx[row]]) in {(sem[j], ins[j]) for j in nn[k]}
    # Real labels, not the default all-zero fallback.
    assert len(np.unique(ps)) > 3


def test_viridis_table_matches_matplotlib(runs):
    from matplotlib import cm

    from ipcgen_tpu_torch.utils.viridis import viridis_rgb

    n = len(runs["port"].frames)
    for i in range(n):
        np.testing.assert_array_equal(viridis_rgb(i / n), np.asarray(cm.viridis(i / n)[:3]))
    # And the combined cloud carries those colours, frame by frame.
    from ipcgen_tpu.io.ply import read_point_cloud

    _, cols, _ = read_point_cloud(runs["port_dir"] / "combined_pointcloud.ply")
    _, jcols, _ = read_point_cloud(runs["jax_dir"] / "combined_pointcloud.ply")
    np.testing.assert_array_equal(np.unique(cols, axis=0), np.unique(jcols, axis=0))


def test_manual_trajectory_branch(tmp_path):
    """``use_auto_trajectory=False`` plans a straight path between two points
    and runs one simulation (the JAX branch at simulator.py:595-609)."""
    from ipcgen_tpu_torch.sim.simulator import run_single_scene_simulation

    mesh_path = tmp_path / "mesh_dense.ply"
    TriMesh.box(center=tuple(ROOM / 2), size=tuple(ROOM), inward=True).save(mesh_path)
    scene = run_single_scene_simulation(
        str(mesh_path), scene_name="office_1", num_waypoints=3,
        output_base_dir=str(tmp_path), use_blk2go=False,
        lidar_horizontal_res=100, use_auto_trajectory=False,
        s3dis_data_root=str(GOLDEN), area="Area_1", room="office_1",
        device="cpu")
    assert len(scene.frames) == 3 and all(len(f.points) == 800 for f in scene.frames)
    _, _, sem, _ = read_labeled_ply(tmp_path / "office_1" / PLY)
    assert len(sem) == 2400 and len(np.unique(sem)) > 3
