"""The port's visualisers against the JAX package's on the CPU.

Every visualiser draws the inputs of tests/test_viz.py (made from one seed
with numpy) in both packages; the decoded PNG pixels must be equal
(``matplotlib.image.imread``), the visualisation summary's text equal and
the combined-frames PLY equal byte for byte.  ``save_results`` with
``save_visualizations=True`` writes the JAX package's file set.  Without
matplotlib the port's ``viz`` imports and a draw raises ``ImportError``;
where the JAX simulator swallows an error of the scene figures, the port's
raises it.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("matplotlib")
torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from matplotlib.image import imread  # noqa: E402

import ipcgen_tpu.containers as jc  # noqa: E402
import ipcgen_tpu.trajectory as jt  # noqa: E402
import ipcgen_tpu.viz as jv  # noqa: E402
import ipcgen_tpu_torch.containers as pc  # noqa: E402
import ipcgen_tpu_torch.trajectory as pt  # noqa: E402
import ipcgen_tpu_torch.viz as pv  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "fixtures" / "golden_room"
BOUNDS = {"x_min": 0, "x_max": 4, "y_min": 0, "y_max": 3, "z_min": 0, "z_max": 2.5}
SIDES = {"jax": (jc, jt, jv), "port": (pc, pt, pv)}


def sim_scene(c, n_frames=3, n_points=200, seed=0):
    """tests/test_viz.py's scene, in the containers ``c`` of one package;
    25,000 points a frame when ``n_points`` asks, so the 20,000-point
    subsampling runs."""
    rng = np.random.default_rng(seed)
    scene = c.S3DISSimScene("viz_room")
    for i in range(n_frames):
        pts = rng.uniform(0, 3, (n_points, 3))
        ang = rng.uniform(0, 90, n_points)
        q = c.ScanQuality(0.8, n_points, float(ang.mean()), float(ang.std()), 10.0, 2.0, 0.5)
        scene.append_frame(c.S3DISSimFrame(i, pts, ang, q))
    scene.compute_statistics(1.0)
    return scene


def box_room(c):
    return c.TriMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)


def assert_same_pixels(a, b):
    a, b = Path(a), Path(b)
    assert a.name == b.name and a.is_file() and b.is_file(), (a, b)
    pa, pb = imread(a), imread(b)
    assert pa.shape == pb.shape, (a.name, pa.shape, pb.shape)
    assert np.array_equal(pa, pb), a.name


def both(tmp_path, draw):
    """``draw(c, t, v, out_dir)`` for each package; the two results."""
    return [draw(*mods, tmp_path / side) for side, mods in SIDES.items()]


def test_trajectory_visualizer_pixels(tmp_path):
    def draw(c, t, v, out):
        viz = v.TrajectoryVisualizer(out)
        wps = [t.Waypoint(0.5 + 0.1 * i, 1.0 + 0.05 * i, 1.0, 0.1 * i, timestamp=i)
               for i in range(15)]
        furn = [t.FurnitureInfo("t", np.array([2.0, 1.5, 0.5]), np.array([1, 1, 1]),
                                "table")]
        return [viz.visualize_trajectory_2d(wps, BOUNDS, furniture=furn),
                viz.visualize_trajectory_3d(wps, BOUNDS),
                viz.visualize_trajectory_comparison({"a": wps, "b": wps[::2]}, BOUNDS),
                viz.visualize_trajectory_statistics(wps)]

    for a, b in zip(*both(tmp_path, draw)):
        assert_same_pixels(a, b)


@pytest.mark.parametrize("n_points", [200, 25_000])
def test_scan_visualizer_pixels(tmp_path, n_points):
    def draw(c, t, v, out):
        viz = v.ScanResultVisualizer(out)
        scene = sim_scene(c, n_points=n_points)
        return [viz.visualize_scan_statistics(scene),
                viz.visualize_frame_pointcloud(scene.frames[0]),
                viz.visualize_incident_angle_distribution(scene),
                viz.visualize_scan_quality_evolution(scene),
                viz.create_scan_summary_report(scene)]

    for a, b in zip(*both(tmp_path, draw)):
        assert_same_pixels(a, b)


def test_mesh_visualizer_pixels(tmp_path):
    def draw(c, t, v, out):
        # max_faces below the room's 12 faces, so the subsampling runs.
        viz = v.MeshVisualizer(out, max_faces=7)
        room = box_room(c)
        wps = [t.Waypoint(1.0 + 0.2 * i, 1.5, 1.0, 0) for i in range(5)]
        furn = [t.FurnitureInfo("t", np.array([2.0, 1.5, 0.5]), np.array([1, 1, 1]),
                                "table")]
        return [viz.visualize_room_mesh(room, BOUNDS),
                viz.visualize_mesh_with_trajectory(room, wps, BOUNDS),
                viz.visualize_mesh_with_furniture(room, furn, BOUNDS),
                viz.visualize_mesh_statistics(room, BOUNDS)]

    for a, b in zip(*both(tmp_path, draw)):
        assert_same_pixels(a, b)


def test_scene_visualizer_summary_and_combined_ply(tmp_path):
    def draw(c, t, v, out):
        viz = v.S3DISVisualizer(out)
        scene = sim_scene(c, n_frames=6)
        results = viz.generate_all_visualizations(scene, c.S3DISScene("viz_room", box_room(c)),
                                                  num_sample_frames=2)
        return results, v.create_visualization_summary(results, out)

    (rj, sj), (rp, sp) = both(tmp_path, draw)
    assert list(rp) == list(rj)
    assert sp.read_text() == sj.read_text()
    assert "scene_bev" in sp.read_text()
    for name in rj:
        a, b = Path(rj[name]), Path(rp[name])
        if a.suffix == ".ply":
            assert a.read_bytes() == b.read_bytes(), name
        else:
            assert_same_pixels(a, b)


def test_normals_viz_pixels(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 2, (6000, 3))
    normals = rng.normal(size=(6000, 3))
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    colors = rng.uniform(0, 1, (6000, 3))

    def draw(c, t, v, out):
        assert v.visualize_normals(pts, None) is None
        assert v.visualize_normal_statistics(normals[:0]) is None
        return [v.visualize_normals(pts, normals, colors=colors, output_path=out / "n.png"),
                v.visualize_normals_high_quality(pts, normals, output_dir=out,
                                                 max_points=5000),
                v.visualize_normal_statistics(normals, out / "ns.png")]

    for a, b in zip(*both(tmp_path, draw)):
        assert_same_pixels(a, b)


def test_save_results_writes_the_jax_file_set(tmp_path):
    """One box-room scan in each package, exported with the figures: the same
    files under the scene directory (the scans differ within the raycast
    contract, so the pixels are not compared here)."""
    from ipcgen_tpu.sim.simulator import S3DISSimulator as JaxSimulator
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator

    mesh = tmp_path / "mesh_dense.ply"
    box_room(pc).save(mesh)
    cfg = {"raycast_engine": {"use_gpu": False}, "lidar": {"horizontal_res": 64},
           "s3dis_data_root": str(GOLDEN), "area": "Area_1", "room": "office_1",
           "seed": 0}
    files = {}
    for side, sim in (("jax", JaxSimulator(cfg, use_dense_lidar=True)),
                      ("port", S3DISSimulator(cfg, use_dense_lidar=True, device="cpu"))):
        scene = sim.run_auto_simulation(str(mesh), num_waypoints=3,
                                        output_dir=tmp_path / side, scene_name="office_1")
        assert len(scene.frames) > 0
        files[side] = sorted(str(p.relative_to(tmp_path / side))
                             for p in (tmp_path / side).rglob("*"))
    assert files["port"] == files["jax"]
    assert "visualizations/trajectory_2d.png" in files["port"]
    assert "visualization_summary.md" in files["port"]
    assert (tmp_path / "port" / "visualization_summary.md").read_text() == \
        (tmp_path / "jax" / "visualization_summary.md").read_text()


def test_scene_figure_errors_raise_where_jax_swallows(tmp_path, monkeypatch):
    """The JAX simulator's ``try/except Exception: pass`` around the scene
    figures (ipcgen_tpu/sim/simulator.py:414-420) is not kept."""
    import ipcgen_tpu.viz.scene_viz as jax_scene_viz
    from ipcgen_tpu.sim.simulator import S3DISSimulator as JaxSimulator
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator

    def fail(*args, **kwargs):
        raise RuntimeError("figure failed")

    monkeypatch.setattr(jax_scene_viz.S3DISVisualizer, "generate_all_visualizations", fail)
    monkeypatch.setattr(pv.S3DISVisualizer, "generate_all_visualizations", fail)
    mesh = tmp_path / "mesh_dense.ply"
    box_room(pc).save(mesh)
    cfg = {"raycast_engine": {"use_gpu": False}, "lidar": {"horizontal_res": 32}, "seed": 0}
    JaxSimulator(cfg).run_auto_simulation(str(mesh), num_waypoints=2,
                                          output_dir=tmp_path / "jax", scene_name="room")
    with pytest.raises(RuntimeError, match="figure failed"):
        S3DISSimulator(cfg, device="cpu").run_auto_simulation(
            str(mesh), num_waypoints=2, output_dir=tmp_path / "port", scene_name="room")


BLOCKED = textwrap.dedent("""
    import sys
    sys.modules["matplotlib"] = None  # any import of it raises ImportError
    import numpy as np
    import ipcgen_tpu_torch.viz as pv
    from ipcgen_tpu_torch.trajectory import Waypoint

    wps = [Waypoint(1.0 + 0.1 * i, 1.5, 1.0, 0.0) for i in range(3)]
    bounds = {"x_min": 0, "x_max": 4, "y_min": 0, "y_max": 3, "z_min": 0, "z_max": 2.5}
    draws = [
        lambda: pv.TrajectoryVisualizer(sys.argv[1]).visualize_trajectory_2d(wps, bounds),
        lambda: pv.visualize_normal_statistics(np.ones((4, 3)), sys.argv[1] + "/n.png"),
    ]
    for draw in draws:
        try:
            draw()
        except ImportError:
            continue
        raise SystemExit("a draw without matplotlib did not raise ImportError")
    print("VIZ_BLOCKED_OK")
""")


def test_viz_imports_without_matplotlib_and_a_draw_raises(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", BLOCKED, str(tmp_path)],
                          capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0 and "VIZ_BLOCKED_OK" in proc.stdout, proc.stderr[-3000:]
