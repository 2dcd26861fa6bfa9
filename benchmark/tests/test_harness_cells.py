"""Whole runs of the cells at a size the CPU holds (``conftest.shrink``),
the pipeline cell held out of BENCHMARK.json among them, the harness's look for a card skipped:
each cell's run is correct, a cell added as files runs with no edit to the
harness, the control fails, and a run whose timed path is broken
underneath is not correct.  The same runs on the card are
``test_harness_card.py``."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import run
from benchmark.tests.conftest import with_pipeline

SPEC = with_pipeline(json.loads((run.ROOT / "BENCHMARK.json").read_text()))
CELLS = [c["name"] for c in SPEC["workloads"]]
SIM, PIPELINE = "sim.office.blk2go", "pipeline.office.blk2go"


def tiny_run(tiny_bench, workload, seed=2**31 + 3, **kw):
    bench_dir, bench_path = tiny_bench
    return run.run_cell(workload, seed, 0.0, kw.pop("trace", False), device="cpu",
                        need_device=False, bench_path=bench_path, bench_dir=bench_dir, **kw)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct_and_its_control_fails(tiny_bench, workload):
    res = tiny_run(tiny_bench, workload, control=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"} and len(res["metrics"]) == 2
    assert list(res)[-1] == "checks"
    # The host line's diagnostics: one entry per call, whose rooms add up
    # to the rooms done, and the check's seconds.
    host = res["host"]
    assert host["calls"] == len(host["call_s"]) == len(host["call_rooms"]) >= 1
    assert all(s > 0 for s in host["call_s"])
    assert sum(host["call_rooms"]) == res["attempted"] - res["failed"]
    assert host["check_s"] > 0
    control = res["control_checks"]
    assert any(c["value"] > c["limit"] for c in control.values()), control


def test_traced_run_reports_the_layers(tiny_bench):
    res = tiny_run(tiny_bench, SIM, trace=True)
    assert res["correct"]
    # No device trace on the CPU: the span metrics only.
    assert {"load_scene_s.sim", "scan_s.sim", "label_join_wait_s.sim"} <= set(res["metrics"])
    assert "device_idle.sim" not in res["metrics"]


def test_a_cell_added_as_files_runs_without_editing_the_harness(tiny_bench):
    bench_dir, bench_path = tiny_bench
    spec = json.loads(bench_path.read_text())
    sim = next(c for c in spec["workloads"] if c["name"] == SIM)
    traffic = json.loads((bench_dir / "traffic" / f"{sim['traffic']}.json").read_text())
    traffic.update(name="office-batch2", rooms_per_call=1, pool_rooms=1)
    (bench_dir / "traffic" / "office-batch2.json").write_text(json.dumps(traffic))
    config = json.loads((bench_dir / "configs" / f"{sim['config']}.json").read_text())
    config["name"] = "s3dis-office-sim-long"
    config["simulation"]["num_waypoints"] = 25  # the planner scans 50
    config["lidar"]["frames_per_room"] = 50
    (bench_dir / "configs" / "s3dis-office-sim-long.json").write_text(json.dumps(config))
    spec["configs"].append({"name": "s3dis-office-sim-long", "source": "test",
                            "file": "benchmark/configs/s3dis-office-sim-long.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "sim.office.long", "config": "s3dis-office-sim-long",
                              "traffic": "office-batch2", "chips": 1, "why": "test"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if SIM in m.get("workloads", []):
            m["workloads"].append("sim.office.long")
    bench_path.write_text(json.dumps(spec))
    res = tiny_run(tiny_bench, "sim.office.long")
    assert res["correct"], res["checks"]
    assert {"sim_rooms_per_h", "setup_s"} == set(res["metrics"])


def _sim_fault(monkeypatch, fault):
    from ipcgen_tpu_torch.containers.sim_scene import S3DISSimScene
    from ipcgen_tpu_torch.sim.scan import ScanBatch
    from ipcgen_tpu_torch.trajectory.auto import AutoTrajectoryGenerator

    points_and_mask = ScanBatch.points_and_mask
    labels = S3DISSimScene._get_colors_and_labels_from_s3dis
    plan = AutoTrajectoryGenerator.generate_optimal_trajectory

    def broken_scan(self):
        if fault == "hits_doubled":  # half the rays cast, each hit written twice
            self.points[:, 1::2], self.mask[:, 1::2] = self.points[:, ::2], self.mask[:, ::2]
            return points_and_mask(self)
        pts, mask = points_and_mask(self)
        pts, mask = pts.copy(), mask.copy()
        if fault == "state_unchanged":  # every waypoint returns the first one's hits
            pts[1:], mask[1:] = pts[0], mask[0]
        elif fault == "half_left_out":  # every other ray of each waypoint dropped
            mask[:, ::2] = False
        elif fault == "points_altered":  # every hit 1 mm off its (axis-aligned) surface
            pts = pts + np.float32(1e-3)
        return pts, mask

    def broken_labels(self, points):
        colors, sem, ins = labels(self, points)
        ins = np.array(ins)
        ins[::10] += 1
        return colors, sem, ins

    def one_spot(self, *a, **k):  # every waypoint at the first one's valid spot
        waypoints, info = plan(self, *a, **k)
        return [waypoints[0]] * len(waypoints), info

    if fault == "labels_altered":
        monkeypatch.setattr(S3DISSimScene, "_get_colors_and_labels_from_s3dis", broken_labels)
    elif fault == "waypoint_repeated":
        monkeypatch.setattr(AutoTrajectoryGenerator, "generate_optimal_trajectory", one_spot)
    else:
        monkeypatch.setattr(ScanBatch, "points_and_mask", broken_scan)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "points_altered",
                                   "labels_altered", "waypoint_repeated", "hits_doubled"])
def test_sim_cell_is_not_correct_with_a_fault(tiny_bench, monkeypatch, fault):
    _sim_fault(monkeypatch, fault)
    res = tiny_run(tiny_bench, SIM)
    assert not res["correct"], res["checks"]
    if fault == "hits_doubled":  # caught by the twins alone: rays, counts and labels hold
        assert [k for k, c in res["checks"].items() if c["value"] > c["limit"]] == \
            ["twin_share"], res["checks"]


def _pipeline_fault(monkeypatch, fault):
    if fault == "state_unchanged":  # outlier removal hands its input back
        from ipcgen_tpu_torch.ops import outliers

        monkeypatch.setattr(outliers, "_threshold_mask",
                            lambda d, r: (np.isfinite(d) | True, float("inf")))
    elif fault == "half_left_out":  # half of the mesh's faces not written
        from ipcgen_tpu_torch.recon.reconstructor import S3DISReconstructor

        save = S3DISReconstructor.save_mesh

        def save_half(self, mesh, path, *a, **k):
            mesh.triangles = mesh.triangles[::2]
            return save(self, mesh, path, *a, **k)

        monkeypatch.setattr(S3DISReconstructor, "save_mesh", save_half)
    elif fault == "boxes_altered":  # each box's low corner 2 cm off
        from ipcgen_tpu_torch.bbox import detection

        calc = detection.calculate_bbox

        def shifted(points):
            box = calc(points)
            if box is not None:
                box["min_coords"] = box["min_coords"] - 0.02
            return box

        monkeypatch.setattr(detection, "calculate_bbox", shifted)


@pytest.mark.parametrize("fault", ["state_unchanged", "half_left_out", "boxes_altered"])
def test_pipeline_cell_is_not_correct_with_a_fault(tiny_bench, monkeypatch, fault):
    _pipeline_fault(monkeypatch, fault)
    res = tiny_run(tiny_bench, PIPELINE)
    assert not res["correct"], res["checks"]
