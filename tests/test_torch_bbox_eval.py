"""The metrics, the eval stage and the bbox stage of the port against the JAX
package on the CPU.

The same seeded numpy inputs go through the JAX function and its
counterpart in ``ipcgen_tpu_torch``.  Tolerances, and why:

- distances: the port takes direct differences and sits within 1e-5
  relative of a float64 reference; the JAX package's norm expansion
  |a|^2 - 2 a.b + |b|^2 (``Precision.HIGHEST``) is held to its own bound, a
  few float32 steps of |a|^2 + |b|^2 in each squared distance;
- MMD: kernel sums of float32 terms, the port's summed in float64, within
  1e-6 absolute of float64;
- reports, JSON and boxes: host numpy on the same points, equal (the
  outlier removal's k-NN means differ by float32 rounding, which moves no
  point across the threshold on these inputs).
"""

import json
import random
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

import importlib  # noqa: E402

from scipy.spatial import cKDTree  # noqa: E402

from ipcgen_tpu.bbox import cli as jbcli  # noqa: E402
from ipcgen_tpu.bbox import detection as jdet  # noqa: E402
from ipcgen_tpu.eval import evaluate as jev  # noqa: E402
from ipcgen_tpu.io.ply import write_labeled_ply, write_point_cloud  # noqa: E402
from ipcgen_tpu_torch.bbox import cli as pbcli  # noqa: E402
from ipcgen_tpu_torch.bbox import detection as pdet  # noqa: E402
from ipcgen_tpu_torch.eval import evaluate as pev  # noqa: E402
from ipcgen_tpu_torch.ops import metrics as pm  # noqa: E402

jm = importlib.import_module("ipcgen_tpu.ops.metrics")
CPU = dict(device="cpu")
F32 = float(np.finfo(np.float32).eps)


def clouds(seed=0, n=3000, m=2500):
    rng = np.random.default_rng(seed)
    x = (rng.uniform(0, 1, (n, 3)) * [4, 3, 2.5]).astype(np.float32)
    y = (rng.uniform(0, 1, (m, 3)) * [4.1, 3, 2.4] + [0.02, 0.0, 0.01]).astype(np.float32)
    return x, y


def d2_64(a, b):
    return ((a[:, None, :].astype(np.float64) - b[None, :, :].astype(np.float64)) ** 2).sum(-1)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------
def test_pairwise_and_directed_distances(monkeypatch):
    monkeypatch.setattr(pm, "ROWS", 256)  # three tiles of queries
    x, y = clouds(1, 700, 9000)  # more than two 4,096 blocks of refs
    ref = d2_64(x, y)
    got = pm._pairwise_d2(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-12)
    want = np.asarray(jm._pairwise_d2(x, y))
    norms = (x.astype(np.float64) ** 2).sum(1)[:, None] + (y.astype(np.float64) ** 2).sum(1)
    assert np.all(np.abs(want - ref) <= 8 * F32 * norms)  # the norm expansion's own bound
    best = np.sqrt(ref.min(axis=1))
    got = pm._directed_min_dists(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, best, rtol=1e-5)
    want = np.asarray(jm._directed_min_dists(x, y))
    assert np.all(np.abs(want ** 2 - best ** 2) <= 8 * F32 * norms.max(axis=1))


def test_metrics_match_float64_and_jax():
    x, y = clouds()
    ref_xy, ref_yx = np.sqrt(d2_64(x, y).min(1)), np.sqrt(d2_64(y, x).min(1))
    cd = pm.compute_chamfer_distance(x, y, **CPU)
    hd = pm.compute_hausdorff_distance(x, y, **CPU)
    cdm = pm.chamfer_distance_mean(x, y, **CPU)
    assert cd == pytest.approx(ref_xy.mean() + ref_yx.mean(), rel=1e-5)
    assert hd == pytest.approx(max(ref_xy.max(), ref_yx.max()), rel=1e-5)
    assert cdm == pytest.approx((ref_xy.mean() + ref_yx.mean()) / 2, rel=1e-5)
    # The JAX package: its norm expansion errs by up to about sqrt(eps * |p|^2)
    # in a distance near 0, a relative error of about 1e-3 on these means.
    assert cd == pytest.approx(jm.compute_chamfer_distance(x, y), rel=2e-3)
    assert hd == pytest.approx(jm.compute_hausdorff_distance(x, y), rel=2e-3)
    xs, ys = x[:1500], y[:1200]
    for gamma in (1.0, 10.0):
        kxx, kyy, kxy = (np.exp(-gamma * d2_64(a, b)).mean() for a, b in
                         ((xs, xs), (ys, ys), (xs, ys)))
        mmd = pm.compute_mmd(xs, ys, gamma=gamma, **CPU)
        assert abs(mmd - (kxx + kyy - 2 * kxy)) <= 1e-6
        assert abs(mmd - jm.compute_mmd(xs, ys, gamma=gamma)) <= 1e-5
    assert pm.density(x) == jm.density(x) and pm.density(x[:0]) == 0.0


def test_subsampling_draws_as_jax():
    x, y = clouds(2, 6000, 5500)
    np.testing.assert_array_equal(pm.sample_points(x, 1000, np.random.default_rng(3)),
                                  jm.sample_points(x, 1000, np.random.default_rng(3)))
    assert pm.sample_points(x, 10000) is x
    got = pm.compute_chamfer_distance(x, y, rng=np.random.default_rng(4), **CPU)
    want = jm.compute_chamfer_distance(x, y, rng=np.random.default_rng(4))
    assert got == pytest.approx(want, rel=2e-3)


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    x, _ = clouds()
    sim_ply = root / "sim.ply"
    write_point_cloud(sim_ply, x)
    data_root = root / "lidar_net"
    rng = np.random.default_rng(5)
    for name, scale in (("roomA", [4.1, 3, 2.4]), ("huge", [40, 30, 25])):
        d = data_root / name
        d.mkdir(parents=True)
        write_point_cloud(d / f"{name}.ply", rng.uniform(0, 1, (2500, 3)) * scale)
    (data_root / "Area_1_office").mkdir()  # an S3DIS area dir: skipped
    return sim_ply, data_root


def test_find_best_match_matches_jax(eval_tree):
    sim_ply, data_root = eval_tree
    assert pev.find_lidar_net_scenes(str(data_root)) == \
        jev.find_lidar_net_scenes(str(data_root))
    want = jev.find_best_match(str(sim_ply), str(data_root), rng=random.Random(0))
    got = pev.find_best_match(str(sim_ply), str(data_root), rng=random.Random(0), **CPU)
    assert got["lidar_net_scene"] == want["lidar_net_scene"] == "roomA"
    assert set(got) == set(want)
    for k, v in want.items():
        if k in ("mmd", "cd", "hd"):
            assert got[k] == pytest.approx(v, rel=2e-3, abs=1e-6), k
        else:
            assert got[k] == v, k
    assert pev.evaluate_single_scene(str(sim_ply), str(data_root / "huge" / "huge.ply"),
                                     **CPU) is None
    pts = np.random.default_rng(0).uniform(5, 10, (100, 3))
    for method in ("center", "min", "none"):
        np.testing.assert_array_equal(pev.normalize_coordinates(pts, method),
                                      jev.normalize_coordinates(pts, method))
    assert pev.check_volume_compatibility(10.0, 12.0) == jev.check_volume_compatibility(10.0, 12.0)


def report_lines(path):
    """The report's lines but the two that carry the clock."""
    return [ln for ln in path.read_text().splitlines()
            if not ln.startswith(("Evaluation time:", "Total time:"))]


def test_evaluate_main_report_matches_jax(eval_tree, tmp_path):
    sim_ply, data_root = eval_tree
    argv = ["--s3dis_ply", str(sim_ply), "--data_root", str(data_root), "--max_points", "3000"]
    want = jev.main(argv + ["--output_dir", str(tmp_path / "jax")])
    got = pev.main(argv + ["--output_dir", str(tmp_path / "port")], **CPU)
    assert got["lidar_net_scene"] == want["lidar_net_scene"]
    name = "single_scene_evaluation.txt"
    lines = report_lines(tmp_path / "port" / name)
    assert lines == report_lines(tmp_path / "jax" / name)
    assert len(lines) == len((tmp_path / "jax" / name).read_text().splitlines()) - 2
    assert pev.main(["--s3dis_ply", str(tmp_path / "missing.ply")], **CPU) is None


# ---------------------------------------------------------------------------
# Bounding boxes
# ---------------------------------------------------------------------------
def test_calculate_bbox_and_gates():
    pts = np.array([[0, 0, 0], [2, 1, 0.5], [1, 0.5, 0.25]])
    got, want = pdet.calculate_bbox(pts), jdet.calculate_bbox(pts)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert pdet.calculate_bbox(np.zeros((0, 3))) is None
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 1, (50, 3))
    pv, jv = pdet.S3DISBBoxVisualizer(**CPU), jdet.S3DISBBoxVisualizer()
    lv, ljv = pdet.LiDARNetBBoxVisualizer(**CPU), jdet.LiDARNetBBoxVisualizer()
    for pts, name in ((base, "chair"), (base, "door"), (base * 0.01, "chair"),
                      (base * [20, 0.8, 0.005], "chair")):
        box = jdet.calculate_bbox(pts)
        assert pv.evaluate_bbox_quality(box, name) == jv.evaluate_bbox_quality(box, name)
        assert lv.evaluate_bbox_quality(box, name) == ljv.evaluate_bbox_quality(box, name)
    for k in ("DETECTION_CLASSES", "CLASS_NAME_MAPPING", "LIDAR_NET_SEMANTIC_MAPPING",
              "CLASS_COLORS", "DEFAULT_BBOX_PARAMS"):
        assert getattr(pdet, k) == getattr(jdet, k), k


def s3dis_room(root, rng):
    """The S3DIS room of tests/test_bbox_eval.py: two chairs, a board and a
    door in Area_1/office_1/Annotations."""
    ann = root / "Area_1" / "office_1" / "Annotations"
    ann.mkdir(parents=True)
    for name, pts in (("chair_1", rng.uniform(0, 0.6, (120, 3)) + [1, 1, 0]),
                      ("chair_2", rng.uniform(0, 0.6, (150, 3)) + [3, 2, 0]),
                      ("board_1", rng.uniform(0, 1, (80, 3)) * [1.2, 0.15, 0.9] + [0, 0, 1]),
                      ("door_1", rng.uniform(0, 1, (60, 3)))):
        np.savetxt(ann / f"{name}.txt", np.hstack([pts, np.full((len(pts), 3), 128.0)]))
    return root / "Area_1" / "office_1"


def test_s3dis_bboxes_json_matches_jax(tmp_path):
    room = s3dis_room(tmp_path / "data", np.random.default_rng(0))
    want = jdet.S3DISBBoxVisualizer(results_root=str(tmp_path / "jax")).visualize_room_bboxes(room)
    got = pdet.S3DISBBoxVisualizer(results_root=str(tmp_path / "port"),
                                   **CPU).visualize_room_bboxes(room)
    assert sorted(b["object_name"] for b in got) == ["board", "chair", "chair"]
    assert len(got) == len(want)
    rel = "Area_1_office_1/Area_1_office_1_detection_annotations.json"
    assert json.loads((tmp_path / "port" / rel).read_text()) == \
        json.loads((tmp_path / "jax" / rel).read_text())
    assert pdet.S3DISBBoxVisualizer(results_root=str(tmp_path / "x"), **CPU) \
        .visualize_room_bboxes(tmp_path / "nowhere") is None
    # The CLI over the area, as the JAX one.
    argv = ["--data_root", str(tmp_path / "data"), "--area_name", "Area_1"]
    assert len(pbcli.main_s3dis(argv + ["--results_root", str(tmp_path / "cp")], **CPU)) == \
        len(jbcli.main_s3dis(argv + ["--results_root", str(tmp_path / "cj")])) == 3
    assert (tmp_path / "cp" / rel).read_text() == (tmp_path / "cj" / rel).read_text()


def test_lidar_net_bboxes_json_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    pts = np.vstack([rng.uniform(0, 0.5, (200, 3)), rng.uniform(0, 0.5, (180, 3)) + [3, 3, 0],
                     rng.uniform(0, 5, (300, 3))]).astype(np.float32)
    sem = np.concatenate([np.full(380, 19), np.zeros(300)]).astype(np.uint16)
    ins = np.concatenate([np.full(200, 1), np.full(180, 2), np.zeros(300)]).astype(np.uint16)
    ply = tmp_path / "scans" / "TestScene.ply"
    ply.parent.mkdir()
    write_labeled_ply(ply, pts, np.full((len(pts), 3), 127, np.uint8), sem, ins)
    want = jdet.LiDARNetBBoxVisualizer(results_root=str(tmp_path / "jax")) \
        .process_room_instances(ply)
    got = pdet.LiDARNetBBoxVisualizer(results_root=str(tmp_path / "port"), **CPU) \
        .process_room_instances(ply)
    assert {b["instance_id"] for b in got} == {1, 2} and len(got) == len(want)
    rel = "TestScene/TestScene_detection_annotations.json"
    assert json.loads((tmp_path / "port" / rel).read_text()) == \
        json.loads((tmp_path / "jax" / rel).read_text())
    assert (tmp_path / "port" / "TestScene" / "TestScene.ply").read_bytes() == ply.read_bytes()
    argv = ["--data_root", str(ply.parent)]
    assert len(pbcli.main_lidar_net(argv + ["--results_root", str(tmp_path / "cp")], **CPU)) \
        == len(jbcli.main_lidar_net(argv + ["--results_root", str(tmp_path / "cj")])) == 2
    shutil.rmtree(tmp_path / "cp")
    one = pbcli.main_lidar_net(["--ply", str(ply), "--results_root", str(tmp_path / "cp")],
                               **CPU)
    assert len(one) == 2 and (tmp_path / "cp" / rel).is_file()


def test_bbox_boxes_hold_their_points():
    """Every box bounds the points it came from, as a float64 AABB."""
    rng = np.random.default_rng(7)
    vis = pdet.S3DISBBoxVisualizer(**CPU)
    pts = rng.normal(0, 0.2, (400, 3)) + [1.0, 2.0, 0.5]
    kept, _ = vis.remove_outliers(pts)
    box = vis.calculate_bbox(kept)
    np.testing.assert_array_equal(box["min_coords"], kept.min(axis=0))
    np.testing.assert_array_equal(box["max_coords"], kept.max(axis=0))
    mask, _ = jdet.remove_statistical_outliers(pts, nb_neighbors=20, std_ratio=2.0)
    np.testing.assert_array_equal(kept, pts[mask])
    assert len(kept) < len(pts)
    near = cKDTree(kept).query(pts[~mask])[0]
    assert near.min() > 0  # the removed points are not among the kept


def test_bbox_plots(tmp_path):
    pytest.importorskip("matplotlib")
    vis = pdet.S3DISBBoxVisualizer(**CPU)
    box = pdet.calculate_bbox(np.random.default_rng(0).uniform(0, 1, (60, 3)))
    box["object_name"] = "chair"
    assert vis.plot_bboxes_3d([box], "test", tmp_path / "b3.png").exists()
    assert vis.plot_bboxes_2d([box], "XY", "test", tmp_path / "b2.png").exists()
