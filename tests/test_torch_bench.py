"""The port's bench (``ipcgen_tpu_torch/bench.py``) against the JAX
package's ``bench.py`` on the CPU.

``bench.py`` imports ``ipcgen_tpu`` only inside its functions, so it is
loaded from the repository root as a module.  Held to it: the TLS sample
bit for bit at the same seed; the box scan's poses (2 and 20 waypoints)
within 1e-6; the numpy culled CPU baseline on each package's asset of
``synthetic_room(2_000)``, 512 rays, ``best_t`` bit for bit; the direct
workload on the culled kernel against JAX's (``xla`` off the TPU) on 4,096
seeded incoherent rays, hit fraction equal and t bit for bit, and the pair
kernel to the raycast contract against the brute oracle with the same hit
mask on every ray (so also the culled kernel's); the incoherent and
open-scene ray builders against the JAX lines they copy (restated below);
``_timed``'s call count and spread; ``run(device="cpu")`` at a small size:
its compact line has the JAX line's keys plus ``card``, fits 1,900
characters, and no file is written without ``json_out``.
"""

import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu_torch import bench  # noqa: E402
from ipcgen_tpu_torch.ops.raycast import raycast_asset  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset  # noqa: E402
from ipcgen_tpu_torch.utils.synthetic import synthetic_room  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SMALL = bench.Sizes(tris=624, waypoints=2, horizontal_res=64, incoherent_rays=4096,
                    open_rays=2048, open_waypoints=2, tls_points=10_000, recon_voxel=0.2,
                    blk2go_waypoints=2, blk2go_point_rate=20_000,
                    baseline_horizontal_res=16)


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_sample_tls_cloud_is_bit_equal(jax_bench):
    v, t = synthetic_room(624)
    got = bench._sample_tls_cloud(v, t, 5000, seed=3)
    want = jax_bench._sample_tls_cloud(v, t, 5000, seed=3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("waypoints", [2, 20])
def test_build_workload_poses(jax_bench, monkeypatch, waypoints):
    monkeypatch.setattr(jax_bench, "BENCH_TRIS", 624)
    _, jintr, jposes, jn = jax_bench._build_workload(waypoints, horizontal_res=64)
    asset, intr, poses, n = bench._build_workload(waypoints, 64, tris=624, device="cpu")
    assert n == jn == asset.n_tris
    assert intr.horizontal_res == jintr.horizontal_res == 64
    assert list(intr.vertical_degrees) == list(jintr.vertical_degrees)
    assert poses.shape == (waypoints, 4, 4)
    np.testing.assert_allclose(poses, np.asarray(jposes), rtol=0, atol=1e-6)


def test_numpy_culled_raycast_is_bit_equal(jax_bench, monkeypatch):
    from ipcgen_tpu_torch.models import beams

    monkeypatch.setattr(jax_bench, "BENCH_TRIS", 2000)
    jasset, _, _, _ = jax_bench._build_workload(1, horizontal_res=16)
    asset, intr, poses, _ = bench._build_workload(1, 16, tris=2000, device="cpu")
    dirs = beams.gen_vertical_degree_dirs(intr.vertical_degrees, 16).numpy()
    dirs = (dirs @ poses[0][:3, :3].T).astype(np.float32)
    assert len(dirs) == 512
    origins = np.tile(poses[0][:3, 3], (len(dirs), 1)).astype(np.float32)
    got = bench._numpy_culled_raycast(origins, dirs, asset, t_max=intr.max_range)
    want = jax_bench._numpy_culled_raycast(origins, dirs, jasset, t_max=intr.max_range)
    assert np.isfinite(got).mean() > 0.9
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_measure_raycast_direct(jax_bench):
    import jax.numpy as jnp

    from ipcgen_tpu.ops.raycast import raycast_asset as jax_raycast
    from ipcgen_tpu.ops.scene_asset import build_scene_asset as jax_build

    v, t = synthetic_room(624)
    origins, dirs = bench._incoherent_rays(4096, seed=7)
    jasset = jax_build(v, t)
    asset = build_scene_asset(v, t, device="cpu")
    jstats = jax_bench._measure_raycast_direct(jasset, origins, dirs, 20.0, reps=1)
    jres = jax_raycast(jnp.asarray(origins, jnp.float32), jnp.asarray(dirs, jnp.float32),
                       jasset, backend="xla", t_max=20.0)
    stats, res = bench._measure_raycast_direct(asset, origins, dirs, 20.0, "culled", reps=1,
                                               queue=1)
    assert stats["rays"] == jstats["rays"] == 4096
    assert stats["hit_fraction"] == jstats["hit_fraction"] > 0.5
    assert np.array_equal(res.t.numpy(), np.asarray(jres.t))
    assert stats["calls"] == 3 and stats["launches"] == {} and stats["peak_bytes"] is None

    pstats, pres = bench._measure_raycast_direct(asset, origins, dirs, 20.0, "pairs", reps=1,
                                                 queue=1)
    oracle = raycast_asset(torch.as_tensor(origins, dtype=torch.float32),
                           torch.as_tensor(dirs, dtype=torch.float32), asset,
                           backend="brute", t_max=20.0)
    both = pres.hit & oracle.hit
    # Closed triangles decided exactly: the same hit mask as the oracle on
    # every ray (shared-edge ties may still pick the other triangle).
    assert torch.equal(pres.hit, oracle.hit)
    assert (pres.tri_id[both] == oracle.tri_id[both]).float().mean() >= 0.99
    err = (pres.points[both] - oracle.points[both]).norm(dim=1).numpy()
    assert np.percentile(err, 99) <= 5e-3 and err.max() <= 5e-2
    agree = bench._agreement(pres, res)
    assert agree["hit_agree"] == 1.0 and agree["p99_mm"] <= 5.0
    assert pstats["hit_fraction"] == pytest.approx(stats["hit_fraction"], abs=0.01)


def test_measure_raycast_sorted_culled_scatters_back():
    v, t = synthetic_room(624)
    origins, dirs = bench._incoherent_rays(4096, seed=8)
    asset = build_scene_asset(v, t, device="cpu")
    _, direct = bench._measure_raycast_direct(asset, origins, dirs, 20.0, "culled", reps=1,
                                              queue=1)
    _, sorted_ = bench._measure_raycast_sorted(asset, origins, dirs, 20.0, "culled", reps=1,
                                               queue=1)
    for name in direct._fields:
        assert torch.equal(getattr(direct, name), getattr(sorted_, name)), name


def test_incoherent_rays_are_the_jax_lines():
    # bench.py:267-273, restated.
    n = 1000
    rng = np.random.default_rng(0)
    origins = rng.uniform([0.5, 0.5, 0.3], [5.5, 4.5, 2.2], (n, 3))
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    got_o, got_d = bench._incoherent_rays(n)
    assert np.array_equal(got_o, origins) and np.array_equal(got_d, dirs)


def test_open_scene_is_the_jax_lines():
    # bench.py:287-301, restated at r = 2048.
    verts, tris = synthetic_room(2000)
    cz = verts[tris].mean(axis=1)
    keep = ~((cz[:, 2] > 2.45) | (cz[:, 1] > 4.95))
    r = 2048
    phis = np.tile(np.linspace(0, 2 * np.pi, r // 32, endpoint=False), 32)
    thetas = np.repeat(np.deg2rad(np.linspace(15, -20, 32)), r // 32)
    scan_dirs = np.stack(
        [np.cos(thetas) * np.cos(phis), np.cos(thetas) * np.sin(phis),
         np.sin(thetas)], axis=1,
    ).astype(np.float32)
    scan_dirs = np.tile(scan_dirs, (20, 1))
    scan_origins = np.repeat(
        np.stack([np.linspace(1.0, 5.0, 20),
                  np.full(20, 2.5), np.full(20, 1.0)], axis=1), r, axis=0
    ).astype(np.float32)
    got_tris = bench._open_scene_tris(verts, tris)
    assert np.array_equal(got_tris, tris[keep]) and 0 < len(got_tris) < len(tris)
    got_o, got_d = bench._open_scene_rays(r, 20)
    assert np.array_equal(got_o, scan_origins) and np.array_equal(got_d, scan_dirs)


@pytest.mark.parametrize("reps, queue", [(3, 4), (2, 1)])
def test_timed_counts_calls_and_orders_its_spread(reps, queue):
    calls = []

    def run():
        calls.append(1)
        return len(calls)

    stats, out = bench._timed(run, "cpu", reps=reps, queue=queue)
    assert len(calls) == stats["calls"] == 1 + reps + reps * queue == out
    for mode in ("pipelined_s", "per_call_s"):
        s = stats[mode]
        assert 0 <= s["min"] <= s["median"] <= s["max"]
    assert stats["seconds"] == stats["pipelined_s"]["min"]
    assert stats["per_call_seconds"] == stats["per_call_s"]["min"]
    assert stats["launches"] == {} and stats["peak_bytes"] is None


def test_pipeline_summary_carries_the_label_spans(tmp_path):
    spans = {"load_scene": 0.7, "trajectory": 0.2, "dispatch": 0.03, "scan_exec": 0.02,
             "frame_build": 0.2, "save": 1.1, "export_ply": 0.9, "label_nn": 0.4,
             "label_bg_load": 0.01, "label_bg_grid": 0.005, "label_bg_join_wait": 0.9,
             "label_nn_l1_rows": 309166.0}
    path = tmp_path / "pipeline.json"
    path.write_text(json.dumps({"rooms_per_hour_steady": 500.0, "steady_room_seconds": 7.2,
                                "stage_seconds_steady": {"sim": 1.5},
                                "sim_subspans_steady": spans, "card": "cpu"}))
    got = bench._pipeline_summary(path)
    top = got["sim_subspans_top"]
    assert {k for k in spans if k.startswith("label_bg_")} <= set(top)
    assert {"save", "load_scene", "export_ply", "label_bg_join_wait"} <= set(top)
    assert "label_nn_l1_rows" not in top  # a row count, not seconds
    assert got["rooms_per_hour_steady"] == 500.0 and got["source"] == str(path)
    assert bench._pipeline_summary(None) is None


# The keys of the JAX bench's compact line (bench.py:617-638).
JAX_LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "details"}
JAX_DETAIL_KEYS = {"platform", "recon_mesh_faces", "recon_seconds_steady",
                   "box_160k_rays_per_sec", "blk2go_full_noise_rays_per_sec", "pipeline",
                   "note"}


def test_run_on_the_cpu_prints_one_compact_line(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out, line = bench.run("cpu", sizes=SMALL, reps=1, queue=1)
    assert list(tmp_path.iterdir()) == []  # nothing written without json_out
    assert len(line) <= bench.LINE_BUDGET and "\n" not in line
    compact = json.loads(line)
    assert set(compact) == JAX_LINE_KEYS | {"card"} and compact["card"] == "cpu"
    d = compact["details"]
    assert JAX_DETAIL_KEYS <= set(d)
    assert compact["metric"] == "rays_per_sec_per_chip_32line_scan_recon_mesh"
    assert d["platform"] == "cpu" and d["recon_mesh_faces"] > 0
    assert d["baseline_rays_per_sec"] > 0 and compact["vs_baseline"] > 0
    assert set(d["workloads"]) == {"box", "incoherent", "incoherent_sorted", "open_scene",
                                   "recon_mesh", "blk2go_80wp"}
    for w, kernels in d["workloads"].items():
        assert set(kernels) == set(bench.KERNELS), w
        for k, row in kernels.items():
            rps, s_min, s_med, s_max, per_call, peak = row
            assert rps > 0 and s_min <= s_med <= s_max and per_call > 0 and peak is None
    full = out["details"]
    auto = full["auto"]
    assert compact["value"] == pytest.approx(
        full["production_workloads"]["reconstructed_mesh_32line"][auto]["rays_per_sec"],
        rel=1e-5)
    assert full["box"]["auto"]["kernel"] == auto
    for name in ("incoherent_random_rays", "incoherent_random_rays_sorted",
                 "open_scene_32line"):
        assert full["workloads"][name]["pair_lists"]["pairs"] > 0
    assert full["workloads"]["open_scene_32line"]["pairs"]["hit_fraction"] < 1.0

    target = tmp_path / "out" / "bench.json"
    bench.run("cpu", sizes=SMALL, reps=1, queue=1, json_out=str(target))
    assert sorted(p.name for p in tmp_path.rglob("*")) == ["bench.json", "out"]
    assert json.loads(target.read_text())["details"]["baseline_rays_per_sec"] > 0
    assert os.getcwd() == str(tmp_path)
