"""The room recorder (``utils/profiling.py``): spans and counters written to
``profile`` and ``events``, on the clock of ``torch.profiler``'s events;
the batch driver's rooms recorded span by span; and the benchmark's
readers of the spans and counters (``benchmark/metrics``).
"""

import hashlib
import importlib.util
import shutil
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu_torch.containers import TriMesh  # noqa: E402
from ipcgen_tpu_torch.sim import simulator as psim  # noqa: E402
from ipcgen_tpu_torch.utils.profiling import Recorder  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "fixtures" / "golden_room"
ROOMS = ("Area_1_office_1", "Area_1_office_2")
# sha256 of each room's clouds as the batch driver wrote them before the
# recorder (the wider room's hits off the TLS surfaces reach the exact 1-NN).
DIGESTS = {
    ("Area_1_office_1", "combined_pointcloud_with_label.ply"):
        "40d4415e60d7d5bf0b23b5059f05edb681d5fb5e910a284da5c69a92c93a4574",
    ("Area_1_office_1", "combined_pointcloud.ply"):
        "423166252ffec7f8fd081c31d12fde2daa8d4feda08aeaf0cedffde041442fd0",
    ("Area_1_office_2", "combined_pointcloud_with_label.ply"):
        "6f0c10182f7a9c6f372ae407d6b7cb3c0b1f5656a43a08568d8539fef8a38bd3",
    ("Area_1_office_2", "combined_pointcloud.ply"):
        "e996b2a496c2f85bce842b702962ea925122e33969afde21c535e9af229d8170",
}
MAIN_SPANS = {"load_scene", "trajectory", "dispatch", "collect_scan", "export_submit",
              "export_drain", "label_prefetch_wait"}
COLLECT_CHILDREN = {"scan_exec", "d2h", "label_handoff", "frame_build", "statistics"}


def test_recorder_nests_spans_and_adds_repeats():
    rec = Recorder("room")
    with rec.span("outer", cpu="outer_cpu"):
        with rec.span("inner"):
            time.sleep(0.01)
        with rec.span("inner"):
            sum(range(200_000))
    rec.count("rows", 3)
    rec.count("rows", 4)

    def other():
        with rec.span("elsewhere"):
            pass

    t = threading.Thread(target=other, name="worker")
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()

    inner = [e for e in rec.events if e.name == "inner"]
    outer = next(e for e in rec.events if e.name == "outer")
    elsewhere = next(e for e in rec.events if e.name == "elsewhere")
    assert [e.parent for e in inner] == ["outer", "outer"] and outer.parent is None
    assert (elsewhere.parent, elsewhere.thread) == (None, "worker")
    assert all(e.room == "room" and e.thread == "MainThread" for e in inner + [outer])
    assert all(0 <= e.cpu_ns <= e.end_ns - e.start_ns for e in rec.events)
    assert outer.start_ns <= inner[0].start_ns < inner[0].end_ns <= inner[1].start_ns
    assert inner[1].end_ns <= outer.end_ns
    # Repeated keys add up; the profile is in seconds and holds floats only.
    assert rec.profile["inner"] == pytest.approx(
        sum(e.end_ns - e.start_ns for e in inner) / 1e9)
    assert rec.profile["inner"] >= 0.01
    assert rec.profile["outer_cpu"] == pytest.approx(outer.cpu_ns / 1e9)
    assert rec.profile["outer_cpu"] <= rec.profile["outer"]
    assert rec.profile["rows"] == 7.0
    assert all(type(v) is float for v in rec.profile.values())

    # An absorbed recorder's counts add to this room's, its events take its room.
    early = Recorder()
    with early.span("inner"):
        pass
    early.count("rows", 1)
    rec.absorb(early)
    assert rec.profile["rows"] == 8.0 and len(rec.events) == 5
    assert rec.events[-1].room == "room"
    # A span that raises is recorded too.
    with pytest.raises(ValueError):
        with rec.span("fails"):
            raise ValueError
    assert "fails" in rec.profile and rec.events[-1].name == "fails"


def test_span_shares_the_clock_of_the_profiler_and_adds_no_event():
    """The op's kineto start lies inside the span's ``time.time_ns()``
    interval; the span itself puts nothing into the trace."""
    rec = Recorder()
    x = torch.ones(4096)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with rec.span("op_span"):
            x.sum()
    (ev,) = rec.events
    events = list(prof.profiler.kineto_results.events())
    sums = [e for e in events if e.name() == "aten::sum"]
    assert sums
    for e in sums:
        assert ev.start_ns <= e.start_ns() <= e.start_ns() + e.duration_ns() <= ev.end_ns
    assert not any("op_span" in e.name() for e in events)


def make_rooms(root: Path):
    """Two box rooms (4 m and 4.5 m wide) over the golden room's TLS data."""
    recon = root / "reconstruction_results"
    for name, width in zip(ROOMS, (4.0, 4.5)):
        d = recon / name
        d.mkdir(parents=True)
        TriMesh.box(center=(2.0, 1.5, 1.25), size=(width, 3.0, 2.5),
                    inward=True).save(d / "mesh_dense.ply")
    data = root / "s3dis"
    for room in ("office_1", "office_2"):
        shutil.copytree(GOLDEN / "Area_1" / "office_1", data / "Area_1" / room)
        (data / "Area_1" / room / "office_1.txt").rename(data / "Area_1" / room / f"{room}.txt")
    return recon, data


def covered_ns(events) -> int:
    """Nanoseconds of the union of the events' intervals."""
    total, end = 0, None
    for e in sorted(events, key=lambda e: e.start_ns):
        if end is None or e.start_ns > end:
            total += e.end_ns - e.start_ns
            end = e.end_ns
        elif e.end_ns > end:
            total += e.end_ns - end
            end = e.end_ns
    return total


def test_main_records_each_room_on_its_spans(tmp_path):
    recon, data = make_rooms(tmp_path)
    out = tmp_path / "out"
    res = psim.main(reconstruction_dir=str(recon), s3dis_data_root=str(data), device="cpu",
                    output_base_dir=str(out), async_export=True, num_waypoints=3,
                    use_gpu=False, use_blk2go=False, use_dense_lidar=True,
                    lidar_horizontal_res=64, save_visualizations=False)
    assert [n for n, _ in res["successful"]] == list(ROOMS) and not res["failed"]
    for (room, name), digest in DIGESTS.items():
        assert hashlib.sha256((out / room / name).read_bytes()).hexdigest() == digest, \
            (room, name)
    for name, scene in res["successful"]:
        prof, events = scene.profile, scene.events
        assert all(type(v) is float for v in prof.values()), prof
        assert {"export_drain", "collect_scan", "label_nn_query_rows",
                "label_nn_residue_rows", "label_nn_residue", "label_load_bg_cpu",
                "label_bg_color_join"} <= set(prof)
        assert prof["label_nn_query_rows"] == scene.get_total_points()
        assert prof["label_load_bg_cpu"] <= prof["label_load_bg"]
        assert all(e.room == name for e in events)
        by_name = {e.name: e for e in events}
        assert by_name["export_drain"].thread == "MainThread"
        assert by_name["label_load_bg"].thread == "label_prefetch"
        assert by_name["label_nn_bg"].thread == "label_transfer"
        assert by_name["label_nn_l0"].parent == "label_nn_bg"
        assert by_name["save"].thread.startswith("export")
        # collect_scan's children cover it within 5 %.
        collect = by_name["collect_scan"]
        children = [e for e in events if e.parent == "collect_scan"]
        assert {e.name for e in children} == COLLECT_CHILDREN
        assert covered_ns(children) >= 0.95 * (collect.end_ns - collect.start_ns)
        # The main thread's spans cover it from the room's load to its
        # export's submission; the drain and the wait for the prefetch come
        # later, while the next room is under way.
        main = [e for e in events if e.thread == "MainThread" and e.parent is None]
        assert {e.name for e in main} == MAIN_SPANS
        start, submitted = min(e.start_ns for e in main), by_name["export_submit"].end_ns
        owned = [e for e in main if e.end_ns <= submitted]
        assert covered_ns(owned) >= 0.95 * (submitted - start)
    # Over the batch, the rooms' main-thread spans cover main from the first
    # load to the last drain.
    main = [e for _, s in res["successful"] for e in s.events
            if e.thread == "MainThread" and e.parent is None]
    start, end = min(e.start_ns for e in main), max(e.end_ns for e in main)
    assert covered_ns(main) >= 0.95 * (end - start)
    residue = {n: s.profile["label_nn_residue_rows"] for n, s in res["successful"]}
    assert residue[ROOMS[0]] == 0 and residue[ROOMS[1]] > 0
    assert res["successful"][0][1].profile["label_nn_residue"] == 0.0


def load_reader(name: str):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


ROOM_A = {"export_drain": 4.0, "collect_scan": 0.5, "label_load_bg": 3.0,
          "label_load_bg_cpu": 2.5, "label_nn_query_rows": 1000.0,
          "label_nn_residue_rows": 10.0, "label_nn_residue": 1.0,
          "label_prefetch_lead": 3.0}
ROOM_B = {"collect_scan": 0.7, "label_load_bg": 2.0, "label_load_bg_cpu": 0.5,
          "label_nn_query_rows": 3000.0, "label_nn_residue_rows": 0.0,
          "label_nn_residue": 0.0, "label_prefetch_lead": 0.5}
NO_ROWS = {"collect_scan": 0.3}  # a room without labels: no query, no drain
OLD = {"frame_build": 0.3, "label_load_bg": 2.0}  # a program without these spans


@pytest.mark.parametrize("name, rooms, want", [
    ("export_drain_s.sim", [ROOM_A, ROOM_B], 2.0),
    ("export_drain_s.sim", [OLD], None),
    ("collect_scan_s.sim", [ROOM_A, ROOM_B, NO_ROWS], 0.5),
    ("collect_scan_s.sim", [OLD], None),
    ("label_prefetch_offcpu_s.sim", [ROOM_A, ROOM_B, NO_ROWS], 1.0),
    ("label_prefetch_offcpu_s.sim", [OLD], None),
    ("label_residue_share.sim", [ROOM_A, ROOM_B, NO_ROWS], 0.25),
    ("label_residue_share.sim", [NO_ROWS], None),
    ("label_residue_s.sim", [ROOM_A, ROOM_B, NO_ROWS], 1.0 / 3),
    ("label_residue_s.sim", [OLD], None),
    ("label_residue_s.sim", [], None),
    ("label_prefetch_lead_s.sim", [ROOM_A, ROOM_B, NO_ROWS], 3.5 / 3),
    ("label_prefetch_lead_s.sim", [OLD], None),
])
def test_span_metric_readers(name, rooms, want):
    got = load_reader(name)({"rooms": rooms, "scan": {}})
    assert got == (None if want is None else pytest.approx(want))
