"""The port's batch entry points against the JAX package's on the CPU: scene
discovery, ``main`` with skip and resume and the asynchronous export,
``main_single``, ``run_complete_simulation`` and the label prewarm.

Two box rooms, the dense 32-line profile at 256 azimuth steps.  The scans
of the two packages are held to the same per-scene point counts within
0.5 % (their kernels differ in float32 rounding at silhouette edges, see
tests/test_torch_scan.py); which scenes ``main`` ran, skipped or failed,
and the files it writes, must be the same.
"""

import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.containers import TriMesh as JaxMesh  # noqa: E402
from ipcgen_tpu.sim import simulator as jsim  # noqa: E402
from ipcgen_tpu_torch.containers import TriMesh  # noqa: E402
from ipcgen_tpu_torch.containers import sim_scene as psim_scene  # noqa: E402
from ipcgen_tpu_torch.io.ply import read_labeled_ply  # noqa: E402
from ipcgen_tpu_torch.sim import simulator as psim  # noqa: E402
from ipcgen_tpu_torch.trajectory import PathType  # noqa: E402

GOLDEN = Path(__file__).parent / "fixtures" / "golden_room"
ROOMS = ("Area_1_office_1", "Area_1_office_2")
SCAN = dict(num_waypoints=3, use_gpu=False, use_blk2go=False, use_dense_lidar=True,
            lidar_horizontal_res=256, save_visualizations=False)
OUTPUTS = ("combined_pointcloud.ply", "combined_pointcloud_with_label.ply",
           "simulation_statistics.txt", "simulation_summary.txt",
           "trajectory_analysis.json")


def make_recon(root: Path, names=ROOMS, widths=(4.0, 5.0)) -> Path:
    recon = root / "reconstruction_results"
    for name, width in zip(names, widths):
        d = recon / name
        d.mkdir(parents=True)
        room = TriMesh.box(center=(2.0, 1.5, 1.25), size=(width, 3.0, 2.5), inward=True)
        room.save(d / "mesh_dense.ply")
        room.save(d / "mesh_sparse50.ply")  # discovery must prefer mesh_dense.ply
    (recon / "not_a_scene").mkdir()
    return recon


def names(result):
    return ([n for n, _ in result["successful"]], sorted(result["skipped"]),
            [n for n, _ in result["failed"]])


def test_find_available_scenes(tmp_path):
    recon = make_recon(tmp_path)
    got = psim.find_available_scenes(str(recon))
    assert got == jsim.find_available_scenes(str(recon))
    assert [Path(p).name for p, _, _ in got] == ["mesh_dense.ply"] * 2
    assert [(n, a) for _, n, a in got] == [(n, n) for n in ROOMS]
    assert psim.find_available_scenes(str(tmp_path / "missing")) == []


@pytest.mark.parametrize("area_room", [
    "Area_1_office_1", "Area_5_conferenceRoom_2", "Area_6_hallway_10", "office_1",
    "office", "Area_1", "x_y_z", "",
])
def test_parse_area_room(area_room):
    assert psim._parse_area_room(area_room) == jsim._parse_area_room(area_room)


def test_main_skip_resume_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    recon = make_recon(tmp_path)
    runs = {}
    for name, pkg, extra in (("jax", jsim, {}), ("port", psim, {"device": "cpu"})):
        out = tmp_path / name
        # No data root: default labels on both sides.
        kw = dict(reconstruction_dir=str(recon), output_base_dir=str(out),
                  s3dis_data_root="", **SCAN, **extra)
        first = pkg.main(**kw)
        second = pkg.main(**kw)
        (out / ROOMS[0] / "simulation_statistics.txt").unlink()
        third = pkg.main(**kw)
        runs[name] = (first, second, third)
        for room in ROOMS:
            assert all((out / room / f).is_file() for f in OUTPUTS), (name, room)
    for j, p in zip(runs["jax"], runs["port"]):
        assert names(p) == names(j)
    assert names(runs["port"][0]) == (list(ROOMS), [], [])
    assert names(runs["port"][1]) == ([], list(ROOMS), [])
    assert names(runs["port"][2]) == ([ROOMS[0]], [ROOMS[1]], [])
    assert runs["port"][0]["total_time"] > 0
    for (_, j), (_, p) in zip(runs["jax"][0]["successful"], runs["port"][0]["successful"]):
        nj, np_ = j.get_total_points(), p.get_total_points()
        assert abs(np_ - nj) <= 0.005 * nj, (nj, np_)
        assert len(p.frames) == len(j.frames)


def test_async_and_sync_export_write_the_same_files(tmp_path):
    # Both rooms are the golden room's box, so every hit lies on its TLS
    # surfaces and the label grid resolves it (no exact residue on the CPU).
    recon = make_recon(tmp_path, widths=(4.0, 4.0))
    root = tmp_path / "s3dis"
    for room in ("office_1", "office_2"):  # the golden room's TLS data for both
        shutil.copytree(GOLDEN / "Area_1" / "office_1", root / "Area_1" / room)
        (root / "Area_1" / room / "office_1.txt").rename(root / "Area_1" / room / f"{room}.txt")
    kw = dict(reconstruction_dir=str(recon), s3dis_data_root=str(root), device="cpu",
              **SCAN)
    # room_dp with no more than one card runs the sequential path.
    sync = psim.main(output_base_dir=str(tmp_path / "sync"), room_dp=True, **kw)
    asyn = psim.main(output_base_dir=str(tmp_path / "async"), async_export=True, **kw)
    assert names(sync) == names(asyn) == (list(ROOMS), [], [])
    files = {d: sorted(str(p.relative_to(tmp_path / d)) for p in (tmp_path / d).rglob("*"))
             for d in ("sync", "async")}
    assert files["sync"] and all(f"{r}/{o}" in files["sync"] for r in ROOMS for o in OUTPUTS)
    assert files["sync"] == files["async"]
    for room in ROOMS:
        for f in ("combined_pointcloud_with_label.ply", "combined_pointcloud.ply"):
            assert (tmp_path / "sync" / room / f).read_bytes() == \
                (tmp_path / "async" / room / f).read_bytes(), (room, f)
    _, _, sem, _ = read_labeled_ply(tmp_path / "async" / ROOMS[1]
                                    / "combined_pointcloud_with_label.ply")
    assert len(np.unique(sem)) > 3  # the golden room's labels
    for _, scene in asyn["successful"]:
        assert scene.save_future.done() and "save" in scene.profile


def test_missing_annotations_give_default_labels_as_in_jax(tmp_path, monkeypatch):
    """A data root whose second room has its raw cloud but no
    ``Annotations/``: both packages count both scenes done, and that room's
    labeled PLY carries default labels (0) and grey colours on both sides;
    the annotated room's labels are the same classes in the same shares
    within 1 % (the two scans differ at silhouette edges)."""
    monkeypatch.chdir(tmp_path)
    recon = make_recon(tmp_path, widths=(4.0, 4.0))
    root = tmp_path / "s3dis"
    shutil.copytree(GOLDEN / "Area_1" / "office_1", root / "Area_1" / "office_1")
    (root / "Area_1" / "office_2").mkdir(parents=True)
    shutil.copyfile(GOLDEN / "Area_1" / "office_1" / "office_1.txt",
                    root / "Area_1" / "office_2" / "office_2.txt")
    runs = {}
    for name, pkg, extra in (("jax", jsim, {}), ("port", psim, {"device": "cpu"})):
        runs[name] = pkg.main(reconstruction_dir=str(recon), output_base_dir=str(tmp_path / name),
                              s3dis_data_root=str(root), **SCAN, **extra)
    assert names(runs["port"]) == names(runs["jax"]) == (list(ROOMS), [], [])
    labeled = {name: [read_labeled_ply(tmp_path / name / room
                                       / "combined_pointcloud_with_label.ply")
                      for room in ROOMS] for name in runs}
    for name in runs:
        _, colors, sem, ins = labeled[name][1]
        assert not sem.any() and not ins.any(), name
        assert len(np.unique(colors, axis=0)) == 1, name
    np.testing.assert_array_equal(labeled["port"][1][1][0], labeled["jax"][1][1][0])
    (_, _, s_p, _), (_, _, s_j, _) = labeled["port"][0], labeled["jax"][0]
    assert len(np.unique(s_p)) > 3 and np.array_equal(np.unique(s_p), np.unique(s_j))
    for c in np.unique(s_j):
        assert abs((s_p == c).mean() - (s_j == c).mean()) <= 0.01, c


def test_unreadable_annotation_file_fails_its_scene(tmp_path):
    """An annotation file that exists but cannot be read is an error, not
    missing data: the port fails the scene (the JAX package writes default
    labels)."""
    recon = make_recon(tmp_path, ROOMS[:1])
    root = tmp_path / "s3dis"
    shutil.copytree(GOLDEN / "Area_1" / "office_1", root / "Area_1" / "office_1")
    (root / "Area_1" / "office_1" / "Annotations" / "chair_1.txt").write_bytes(
        bytes(range(128, 256)) * 16)
    res = psim.main(reconstruction_dir=str(recon), output_base_dir=str(tmp_path / "out"),
                    s3dis_data_root=str(root), device="cpu",
                    **dict(SCAN, lidar_horizontal_res=64))
    assert names(res) == ([], [], [ROOMS[0]])
    assert "decode" in res["failed"][0][1]


def test_export_failure_fails_its_scene(tmp_path, monkeypatch):
    recon = make_recon(tmp_path)
    real = psim_scene.S3DISSimScene.save_results

    def save_results(self, output_dir, *args, **kwargs):
        if self.scene_name == ROOMS[1]:
            raise OSError("disk full")
        return real(self, output_dir, *args, **kwargs)

    monkeypatch.setattr(psim_scene.S3DISSimScene, "save_results", save_results)
    res = psim.main(reconstruction_dir=str(recon), output_base_dir=str(tmp_path / "out"),
                    s3dis_data_root="", async_export=True,
                    device="cpu", **dict(SCAN, lidar_horizontal_res=64))
    assert names(res) == ([ROOMS[0]], [], [ROOMS[1]])
    assert res["failed"][0][1] == "disk full"


def test_room_dp_with_more_than_one_card_raises(tmp_path, monkeypatch):
    """With more than one card ``room_dp`` spreads the rooms over the cards
    (tests/test_torch_shard.py), so a caller that asks for the CPU gets an
    error, not the cards."""
    recon = make_recon(tmp_path)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="room_dp"):
        psim.main(reconstruction_dir=str(recon), room_dp=True, device="cpu", **SCAN)
    assert psim.main(reconstruction_dir=str(tmp_path / "missing"), device="cpu") == \
        {"successful": [], "failed": [], "skipped": []}


def test_main_single_matches_jax(tmp_path):
    recon = make_recon(tmp_path, ROOMS[:1])
    mesh = str(recon / ROOMS[0] / "mesh_dense.ply")
    kw = dict(scene_path=mesh, scene_name=ROOMS[0], area="Area_1", room="office_1",
              s3dis_data_root=str(GOLDEN), **SCAN)
    want = jsim.main_single(output_base_dir=str(tmp_path / "jax"), **kw)
    got = psim.main_single(output_base_dir=str(tmp_path / "port"), device="cpu", **kw)
    assert len(got.frames) == len(want.frames)
    assert abs(got.get_total_points() - want.get_total_points()) \
        <= 0.005 * want.get_total_points()
    assert (tmp_path / "port" / ROOMS[0] / "combined_pointcloud_with_label.ply").is_file()


def test_run_complete_simulation_matches_jax(tmp_path):
    """A manual straight trajectory: the port's run, which also draws the
    figures, against the JAX simulator's same steps."""
    recon = make_recon(tmp_path, ROOMS[:1])
    mesh = str(recon / ROOMS[0] / "mesh_dense.ply")
    cfg = {"raycast_engine": {"use_gpu": False}, "lidar": {"horizontal_res": 256}, "seed": 0}
    start, end = (1.0, 1.5, 1.0), (3.0, 1.5, 1.0)
    sim = psim.S3DISSimulator(cfg, use_dense_lidar=True, device="cpu")
    sim.load_scene(mesh, "complete")
    sim.add_furniture(TriMesh.box(center=(2.0, 0.5, 0.3), size=(0.4, 0.4, 0.6)), "box",
                      "table")
    assert sim.collision_detector.furniture_list
    got = sim.run_complete_simulation(mesh, start, end, PathType.STRAIGHT, num_waypoints=4,
                                      output_dir=tmp_path / "port", scene_name="complete")
    jax_sim = jsim.S3DISSimulator(cfg, use_dense_lidar=True)
    jax_sim.load_scene(mesh, "complete")
    jax_sim.add_furniture(JaxMesh.box(center=(2.0, 0.5, 0.3), size=(0.4, 0.4, 0.6)), "box",
                          "table")
    wps, _ = jax_sim.generate_trajectory(start, end, jsim.PathType.STRAIGHT, 4)
    want = jax_sim.run_simulation(wps)
    assert [len(f.points) for f in got.frames] == pytest.approx(
        [len(f.points) for f in want.frames], rel=0.005)
    assert (tmp_path / "port" / "combined_pointcloud_with_label.ply").is_file()
    assert (tmp_path / "port" / "visualizations" / "trajectory_2d.png").is_file()
    assert got.scene_name == "complete"


def test_prewarm_is_claimed_once_and_changes_no_label(tmp_path):
    recon = make_recon(tmp_path, ROOMS[:1])
    kw = dict(reconstruction_dir=str(recon), s3dis_data_root=str(GOLDEN), device="cpu",
              **SCAN)
    pf = psim_scene.prewarm_labels(str(GOLDEN), "Area_1", "office_1", device="cpu")
    assert psim_scene.prewarm_labels(str(GOLDEN), "Area_1", "office_1", device="cpu") is pf
    assert psim_scene.prewarm_labels(str(GOLDEN), None, "office_1", device="cpu") is None
    warm = psim.main(output_base_dir=str(tmp_path / "warm"), **kw)
    assert warm["successful"][0][1].label_prefetch is pf  # load_scene claimed it
    assert psim_scene.claim_prewarmed_labels(str(GOLDEN), "Area_1", "office_1",
                                             device="cpu") is None
    cold = psim.main(output_base_dir=str(tmp_path / "cold"), **kw)
    assert cold["successful"][0][1].label_prefetch is not pf
    ply = Path(ROOMS[0]) / "combined_pointcloud_with_label.ply"
    assert (tmp_path / "warm" / ply).read_bytes() == (tmp_path / "cold" / ply).read_bytes()
    assert "label_bg_join_wait" in warm["successful"][0][1].profile


def test_save_executor_attaches_the_export_future(tmp_path):
    recon = make_recon(tmp_path, ROOMS[:1])
    with ThreadPoolExecutor(max_workers=1) as ex:
        scene = psim.run_single_scene_simulation(
            str(recon / ROOMS[0] / "mesh_dense.ply"), scene_name="exec",
            output_base_dir=str(tmp_path), save_executor=ex, device="cpu",
            **{k: v for k, v in SCAN.items()})
        scene.save_future.result()
    assert all((tmp_path / "exec" / f).is_file() for f in OUTPUTS)


LOOKAHEAD_ROOMS = ("Area_1_office_1", "Area_1_office_2", "Area_1_office_3")


def golden_rooms(root: Path, names=LOOKAHEAD_ROOMS):
    """Box rooms of the golden room's width under ``names``, each with the
    golden room's TLS scan and annotations linked under its own name."""
    recon = make_recon(root, names, widths=(4.0,) * len(names))
    data = root / "s3dis"
    src = (GOLDEN / "Area_1" / "office_1").resolve()
    for name in names:
        room = name.removeprefix("Area_1_")
        d = data / "Area_1" / room
        d.mkdir(parents=True)
        (d / f"{room}.txt").symlink_to(src / "office_1.txt")
        (d / "Annotations").symlink_to(src / "Annotations", target_is_directory=True)
    return recon, data


def no_clock(stats: str):
    """A statistics file's lines without its timing (simulation time, frames
    per second)."""
    clock = ("Simulation time", "Frames per second", "Frame rate")
    return [ln for ln in stats.splitlines() if not ln.strip().startswith(clock)]


def prefetch_threads():
    return {t for t in threading.enumerate() if t.name == "label_prefetch"}


def test_lookahead_writes_what_sync_writes_and_starts_labels_early(tmp_path):
    """``main`` prewarms each room's labels one room ahead and drains each
    export only before the next is queued; the files are those of the
    synchronous export, every room still parses its own annotations, and
    every room after the first started its labels before the room ahead of
    it loaded."""
    recon, data = golden_rooms(tmp_path)
    kw = dict(reconstruction_dir=str(recon), s3dis_data_root=str(data), device="cpu",
              **dict(SCAN, lidar_horizontal_res=64))
    sync = psim.main(output_base_dir=str(tmp_path / "sync"), **kw)
    asyn = psim.main(output_base_dir=str(tmp_path / "async"), async_export=True, **kw)
    assert names(sync) == names(asyn) == (list(LOOKAHEAD_ROOMS), [], [])
    for room in LOOKAHEAD_ROOMS:
        for f in ("combined_pointcloud_with_label.ply", "combined_pointcloud.ply"):
            assert (tmp_path / "sync" / room / f).read_bytes() == \
                (tmp_path / "async" / room / f).read_bytes(), (room, f)
        # The statistics files match but for the run's own clock.
        for f in ("simulation_statistics.txt", "simulation_summary.txt",
                  "trajectory_analysis.json"):
            sync_f, async_f = (no_clock((tmp_path / d / room / f).read_text())
                               for d in ("sync", "async"))
            assert sync_f == async_f and len(sync_f) > 5, (room, f)
    for res in (sync, asyn):
        profiles = [scene.profile for _, scene in res["successful"]]
        for prof in profiles:
            assert {"load_scene", "label_bg_ann_parse", "label_prefetch_lead",
                    "label_prefetch_wait"} <= set(prof)
        for prof in profiles[1:]:
            assert prof["label_prefetch_lead"] > prof["load_scene"], prof
        # Each room's prefetch began before the room ahead of it loaded.
        scenes = [scene for _, scene in res["successful"]]
        for prev, scene in zip(scenes, scenes[1:]):
            handoff = next(e for e in scene.events if e.name == "label_handoff")
            began = handoff.start_ns - scene.profile["label_prefetch_lead"] * 1e9
            assert began < next(e for e in prev.events if e.name == "load_scene").start_ns


def _bad_mesh(recon, out, monkeypatch):
    (recon / LOOKAHEAD_ROOMS[1] / "mesh_dense.ply").write_bytes(b"not a mesh\n")
    return (LOOKAHEAD_ROOMS[0], LOOKAHEAD_ROOMS[2]), (), (LOOKAHEAD_ROOMS[1],)


def _export_raises(recon, out, monkeypatch):
    real = psim_scene.S3DISSimScene.save_results

    def save_results(self, output_dir, *args, **kwargs):
        if self.scene_name == LOOKAHEAD_ROOMS[1]:
            raise OSError("disk full")
        return real(self, output_dir, *args, **kwargs)

    monkeypatch.setattr(psim_scene.S3DISSimScene, "save_results", save_results)
    return (LOOKAHEAD_ROOMS[0], LOOKAHEAD_ROOMS[2]), (), (LOOKAHEAD_ROOMS[1],)


def _skipped(recon, out, monkeypatch):
    done = out / LOOKAHEAD_ROOMS[1]
    done.mkdir(parents=True)
    for f in ("combined_pointcloud_with_label.ply", "simulation_statistics.txt"):
        (done / f).write_text("done\n")
    return (LOOKAHEAD_ROOMS[0], LOOKAHEAD_ROOMS[2]), (LOOKAHEAD_ROOMS[1],), ()


class Interrupted(BaseException):
    pass


def _interrupted(recon, out, monkeypatch):
    real = psim.run_single_scene_simulation

    def run(*args, **kwargs):
        if kwargs["scene_name"] == LOOKAHEAD_ROOMS[1]:
            raise Interrupted
        return real(*args, **kwargs)

    monkeypatch.setattr(psim, "run_single_scene_simulation", run)
    return None


@pytest.mark.parametrize("case", [_bad_mesh, _export_raises, _skipped, _interrupted],
                         ids=["mesh_fails_after_prewarm", "export_raises", "skipped_room",
                              "main_interrupted"])
def test_lookahead_edges(tmp_path, monkeypatch, case):
    """A room that fails fails only itself, a skipped room is never
    prewarmed, and when ``main`` returns or raises it leaves no prewarm of
    its own registered and no prefetch thread running."""
    recon, data = golden_rooms(tmp_path)
    out = tmp_path / "out"
    want = case(recon, out, monkeypatch)  # (ok, skipped, failed), None if main raises
    prewarmed = []
    real_prewarm = psim.prewarm_labels

    def prewarm(root, area, room, **kwargs):
        prewarmed.append(f"{area}_{room}")
        return real_prewarm(root, area, room, **kwargs)

    monkeypatch.setattr(psim, "prewarm_labels", prewarm)
    before = prefetch_threads()
    kw = dict(reconstruction_dir=str(recon), output_base_dir=str(out),
              s3dis_data_root=str(data), async_export=True, device="cpu",
              **dict(SCAN, lidar_horizontal_res=64))
    if want is None:
        with pytest.raises(Interrupted):
            psim.main(**kw)
        assert set(prewarmed) == set(LOOKAHEAD_ROOMS)  # the third was prewarmed ahead
    else:
        res = psim.main(**kw)
        ok, skipped, failed = want
        assert names(res) == (list(ok), list(skipped), list(failed))
        assert set(prewarmed) == set(ok) | set(failed)
        if case is _export_raises:
            assert res["failed"][0][1] == "disk full"
    assert not [k for k in psim_scene._prewarm_registry if k[0] == str(data)]
    assert prefetch_threads() <= before
