"""The port stands alone: it runs where jax, matplotlib and yaml are missing
(as on the GPU host) and without the JAX package.  A subprocess blocks all
four, imports ``ipcgen_tpu_torch`` and runs the sim stage on the CPU through
the port's public entry point, then again through the config tree
(``PipelineConfig.from_dict`` with ``simulation.backend: pallas``, the culled
path), as ``chip_smoke.py`` does on the card; then the batch entry point ``main``
with the asynchronous export, ``preprocess_room``, ``reconstruct_room`` on its
pickle, ``find_best_match`` and the LiDAR-Net boxes on the scans.  A source scan
keeps every ``import`` of jax or of ``ipcgen_tpu`` out of the package and
``chip_smoke.py``, and every import of matplotlib or yaml inside a function."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
GOLDEN = REPO / "tests" / "fixtures" / "golden_room"

SCRIPT = textwrap.dedent("""
    import sys
    BLOCKED = ("jax", "matplotlib", "yaml", "ipcgen_tpu")
    for name in BLOCKED:
        sys.modules[name] = None  # any import of them raises ImportError
    from pathlib import Path

    import numpy as np

    from ipcgen_tpu_torch.containers import TriMesh
    from ipcgen_tpu_torch.io.ply import read_labeled_ply
    from ipcgen_tpu_torch.sim.simulator import run_single_scene_simulation

    out = Path(sys.argv[1])
    mesh = out / "mesh_dense.ply"
    TriMesh.box(center=(2.0, 1.5, 1.2), size=(4.0, 3.0, 2.4), inward=True).save(mesh)
    scene = run_single_scene_simulation(
        str(mesh), scene_name="office_1", num_waypoints=4,
        output_base_dir=str(out), use_blk2go=False, use_dense_lidar=False,
        lidar_horizontal_res=200, s3dis_data_root=sys.argv[2], area="Area_1",
        room="office_1", device="cpu")
    assert len(scene.frames) > 0 and all(len(f.points) for f in scene.frames)
    _, _, sem, _ = read_labeled_ply(out / "office_1" / "combined_pointcloud_with_label.ply")
    assert len(np.unique(sem)) > 3, np.unique(sem)

    from ipcgen_tpu_torch.config import PipelineConfig
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator

    tree = PipelineConfig.from_dict({
        "simulation": {"backend": "pallas", "use_blk2go": False},
        "data": {"data_root": sys.argv[2], "area_name": "Area_1",
                 "room_name": "office_1"}})
    config = dict(tree.simulator_config(), lidar={"horizontal_res": 200})
    sim = S3DISSimulator(config, use_blk2go=False, device="cpu")
    assert sim.backend == "culled"
    culled = sim.run_auto_simulation(str(mesh), num_waypoints=4,
                                     output_dir=out / "culled", scene_name="office_1")
    counts = [len(f.points) for f in culled.frames]
    want = [len(f.points) for f in scene.frames]
    assert len(counts) == len(want) and all(
        abs(a - b) <= 0.005 * b for a, b in zip(counts, want)), (counts, want)
    assert (out / "culled" / "combined_pointcloud_with_label.ply").is_file()

    # ``main`` over a reconstruction directory, with the async export.
    from ipcgen_tpu_torch.sim.simulator import main

    scene_dir = out / "recon" / "Area_1_office_1"
    scene_dir.mkdir(parents=True)
    (scene_dir / "mesh_dense.ply").write_bytes(mesh.read_bytes())
    res = main(str(out / "recon"), num_waypoints=4, output_base_dir=str(out / "batch"),
               use_blk2go=False, s3dis_data_root=sys.argv[2], async_export=True,
               lidar_horizontal_res=200, device="cpu")
    assert [n for n, _ in res["successful"]] == ["Area_1_office_1"] and not res["failed"]

    # The preprocess stage on the golden room.
    from ipcgen_tpu_torch.preprocess import preprocess_room

    room = preprocess_room(sys.argv[2], "Area_1", "office_1", {}, output_dir=str(out / "pre"),
                           seed=0, device="cpu")
    assert room["normals"].shape == room["points"].shape and len(room["points"]) > 10000
    assert Path(room["output_path"]).is_file()

    # Recon on that pickle, then eval and bbox on the scans.
    import random

    from ipcgen_tpu_torch.bbox.detection import LiDARNetBBoxVisualizer
    from ipcgen_tpu_torch.eval.evaluate import find_best_match
    from ipcgen_tpu_torch.recon.cli import reconstruct_room

    cfg = {"nksr": {"voxel_size": 0.1}, "visualization": {"save_visualizations": False},
           "evaluation": {"compute_chamfer": True, "compute_mesh_quality": True,
                          "max_eval_points": 5000}}
    rec = reconstruct_room(room["output_path"], cfg, str(out / "recon_out"), device="cpu")
    assert "error" not in rec["dense"], rec
    assert rec["dense"]["reconstruction_stats"]["output_faces"] > 1000
    assert rec["dense"]["quality_metrics"]["chamfer_distance"] < 0.1
    scan = out / "office_1" / "combined_pointcloud_with_label.ply"
    lidar_net = out / "lidar_net" / "culled_scan"
    lidar_net.mkdir(parents=True)
    (lidar_net / "culled_scan.ply").write_bytes(
        (out / "culled" / "combined_pointcloud.ply").read_bytes())
    match = find_best_match(str(scan), str(out / "lidar_net"), max_points=2000,
                            rng=random.Random(0), device="cpu")
    assert match["lidar_net_scene"] == "culled_scan" and 0 < match["cd"] < 0.5, match
    LiDARNetBBoxVisualizer(results_root=str(out / "boxes"), device="cpu") \
        .process_room_instances(scan)
    assert all(sys.modules[n] is None for n in BLOCKED)
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED + ("jaxlib",)
              and sys.modules[m] is not None]
    assert not leaked, leaked
    print("NO_JAX_OK")
""")


def test_slice_runs_without_jax_matplotlib_yaml(tmp_path):
    """Also without ``ipcgen_tpu``: the subprocess blocks it with the rest."""
    env = dict(os.environ, PYTHONPATH=str(REPO), HOME=str(tmp_path),
               OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path), str(GOLDEN)],
        capture_output=True, text=True, env=env, timeout=300,
    )
    assert proc.returncode == 0 and "NO_JAX_OK" in proc.stdout, (
        proc.stdout[-2000:], proc.stderr[-4000:])


PORT_FILES = sorted((REPO / "ipcgen_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
# ``\b`` ends the name, so ``ipcgen_tpu_torch`` itself does not match.
JAX_IMPORT = re.compile(r"^\s*(import|from)\s+jax\b", re.M)
JAX_PACKAGE_IMPORT = re.compile(r"^\s*(import|from)\s+ipcgen_tpu\b", re.M)


def offenders(pattern):
    assert len(PORT_FILES) > 30
    return [str(f) for f in PORT_FILES if pattern.search(f.read_text())]


def test_no_jax_import_in_port_sources():
    assert not offenders(JAX_IMPORT)


def test_no_jax_package_import_in_port_sources():
    assert not offenders(JAX_PACKAGE_IMPORT)


# An import at the start of a line runs when the module is imported.
TOP_LEVEL_OPTIONAL = re.compile(r"^(import|from)\s+(matplotlib|yaml)\b", re.M)


def test_matplotlib_and_yaml_only_inside_functions():
    assert not offenders(TOP_LEVEL_OPTIONAL)
    assert TOP_LEVEL_OPTIONAL.search("import matplotlib\n")
    assert not TOP_LEVEL_OPTIONAL.search("    import matplotlib\n")


@pytest.mark.parametrize("line, hit", [
    ("    from ipcgen_tpu.containers import TriMesh\n", True),
    ("import ipcgen_tpu\n", True),
    ("from ipcgen_tpu import config\n", True),
    ("from ipcgen_tpu_torch.containers import TriMesh\n", False),
    ("# see ipcgen_tpu/ops/raycast_mxu.py\n", False),
])
def test_source_scan_catches_a_jax_package_import(line, hit):
    assert bool(JAX_PACKAGE_IMPORT.search(line)) == hit
