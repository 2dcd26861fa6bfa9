"""The port's pipeline driver (``ipcgen_tpu_torch.run_pipeline``) against
``scripts/run_pipeline.py`` on the CPU.

The synthetic S3DIS room of tests/test_pipeline_driver.py (made from the
conftest's seeded generator), all five stages, figures on, each package
through its own command line with the same YAML but for its output paths.
Compared: the report's keys and every stage's status; a rerun skips every
stage; the same files under the preprocess, recon, sim and eval outputs of
the room; the labeled cloud's point count within 0.5 % (the tolerance
tests/test_torch_batch.py holds ``main`` to: the scans differ only at
float32 edge ties), and its labels the same classes.  The two packages draw
their random streams differently, so no output is compared byte for byte.

The release gate (``ipcgen_tpu_torch.release_gate_lroom``) runs BLK2GO over
20 waypoints, which takes minutes on the CPU: it is held on the card only
(``chip_smoke.py`` ``phase_release_gate``); here its reference reader is
held to the port's PLY reader.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("yaml")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

from ipcgen_tpu.config import PipelineConfig  # noqa: E402

STAGES = "preprocess,recon,sim,bbox,eval"
SCENE = "Area_1_office_1"


def synthetic_s3dis(tmp_path: Path) -> Path:
    """tests/test_pipeline_driver.py's room (the conftest's generator, seed
    0): a dense room-shell cloud and two annotated objects."""
    rng = np.random.default_rng(0)
    room = tmp_path / "data" / "Area_1" / "office_1"
    ann = room / "Annotations"
    ann.mkdir(parents=True)

    def surface(n, lo, hi, axis, value):
        pts = rng.uniform(0, 1, (n, 3)) * (np.array(hi) - lo) + lo
        pts[:, axis] = value
        return pts

    lo, hi = [0, 0, 0], [3.0, 2.5, 2.2]
    floor = surface(3000, lo, hi, 2, 0.0)
    ceiling = surface(2000, lo, hi, 2, 2.2)
    walls = np.vstack([surface(1200, lo, hi, 0, 0.0), surface(1200, lo, hi, 0, 3.0),
                       surface(1200, lo, hi, 1, 0.0), surface(1200, lo, hi, 1, 2.5)])
    chair = rng.uniform(0, 1, (500, 3)) * [0.5, 0.5, 0.8] + [1.0, 1.0, 0.0]
    table = rng.uniform(0, 1, (600, 3)) * [1.0, 0.7, 0.1] + [1.8, 1.2, 0.7]
    cloud = np.vstack([floor, ceiling, walls, chair, table])
    colors = rng.integers(60, 200, (len(cloud), 3))
    np.savetxt(room / "office_1.txt", np.hstack([cloud, colors]))
    np.savetxt(ann / "floor_1.txt", np.hstack([floor, np.full((len(floor), 3), 90)]))
    np.savetxt(ann / "chair_1.txt", np.hstack([chair, np.full((len(chair), 3), 200)]))
    np.savetxt(ann / "table_1.txt", np.hstack([table, np.full((len(table), 3), 120)]))
    return tmp_path / "data", cloud


def lidar_net_scene(sim_dir: Path, cloud: np.ndarray) -> None:
    """The eval stage's candidate: a LiDAR-Net-layout scene beside the
    simulated one, holding the TLS cloud."""
    from ipcgen_tpu_torch.io.ply import write_labeled_ply

    n = len(cloud)
    write_labeled_ply(sim_dir / "tls_scan" / "tls_scan.ply", cloud.astype(np.float32),
                      np.full((n, 3), 128, np.uint8), np.zeros(n, np.uint16),
                      np.zeros(n, np.uint16))


def config(data_root: Path, out: Path) -> Path:
    cfg = PipelineConfig()
    cfg.data.data_root = str(data_root)
    cfg.data.output_root = str(out / "outputs")
    cfg.data.area_name = "Area_1"
    cfg.data.room_name = "office_1"
    cfg.nksr.voxel_size = 0.08
    cfg.nksr.chunked = False
    cfg.preprocessing.normal_search_radius = 0.3
    cfg.simulation.num_waypoints = 3
    cfg.simulation.use_blk2go = False  # standard 8-line, CPU-friendly
    cfg.simulation.use_auto_trajectory = False
    cfg.simulation.use_gpu = False
    cfg.simulation.save_visualizations = True
    cfg.simulation.output_base_dir = str(out / "simulation_results")
    cfg.evaluation.compute_chamfer = False
    cfg.evaluation.compute_mesh_quality = False
    cfg_path = out / "cfg.yaml"
    cfg.save(cfg_path)
    return cfg_path


def files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both drivers, twice each, from their own working directories (the eval
    report goes to ``./evaluation_results``)."""
    from run_pipeline import main as jax_main

    from ipcgen_tpu_torch.run_pipeline import main as port_main

    tmp_path = tmp_path_factory.mktemp("pipeline")
    data_root, cloud = synthetic_s3dis(tmp_path)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for side, main in (("jax", jax_main),
                           ("port", lambda argv: port_main(argv, device="cpu"))):
            work = tmp_path / side
            work.mkdir()
            mp.chdir(work)
            argv = ["--config", str(config(data_root, work)), "--stages", STAGES]
            lidar_net_scene(work / "simulation_results", cloud)
            out[side] = (work, main(argv), main(argv))
    return out


def test_pipeline_matches_the_jax_driver(runs):
    from ipcgen_tpu_torch.io.ply import read_labeled_ply

    (jwork, jfirst, jsecond), (pwork, pfirst, psecond) = runs["jax"], runs["port"]
    assert set(pfirst) == set(jfirst)
    assert pfirst["rooms"] == jfirst["rooms"]
    assert set(pfirst["rooms"][SCENE]) == set(STAGES.split(","))
    assert pfirst["rooms"][SCENE]["sim"] == "done"
    assert pfirst["rooms"][SCENE]["eval"] == "done"
    assert psecond["rooms"] == jsecond["rooms"]
    assert all(v.startswith("skipped") for v in psecond["rooms"][SCENE].values())
    for sub in ("outputs", "simulation_results", "evaluation_results"):
        assert files(pwork / sub) == files(jwork / sub), sub
    sim = "simulation_results/" + SCENE
    assert f"{sim}/visualizations/trajectory_2d.png" in files(pwork)
    assert (pwork / "outputs" / "pipeline_report.json").is_file()
    ply = Path(sim) / "combined_pointcloud_with_label.ply"
    _, _, sem_p, _ = read_labeled_ply(pwork / ply)
    _, _, sem_j, _ = read_labeled_ply(jwork / ply)
    assert abs(len(sem_p) - len(sem_j)) <= 0.005 * len(sem_j), (len(sem_p), len(sem_j))
    assert np.array_equal(np.unique(sem_p), np.unique(sem_j)) and 1 in set(sem_p.tolist())


def test_run_takes_the_config_tree_without_yaml(runs):
    """``run`` is what ``main`` calls after loading the YAML: on the port's
    outputs every stage skips."""
    from ipcgen_tpu_torch.config import PipelineConfig as PortConfig
    from ipcgen_tpu_torch.run_pipeline import run

    pwork = runs["port"][0]
    cfg = PortConfig.load(pwork / "cfg.yaml")
    report = run(cfg, ["preprocess", "recon", "sim", "bbox"], device="cpu")
    assert all(v.startswith("skipped") for v in report["rooms"][SCENE].values())


def test_release_gate_reader_matches_the_port_reader(runs):
    from ipcgen_tpu_torch.io.ply import read_labeled_ply
    from ipcgen_tpu_torch.release_gate_lroom import reference_read_labeled_ply

    ply = runs["port"][0] / "simulation_results" / SCENE / "combined_pointcloud_with_label.ply"
    ref = reference_read_labeled_ply(ply)
    xyz, _, sem, ins = read_labeled_ply(ply)
    assert np.array_equal(ref["xyz"], xyz)
    assert np.array_equal(ref["sem"], sem) and np.array_equal(ref["ins"], ins)
    assert "end_header" in ref["header"]
