"""The port's multi-device paths (``parallel/shard.py``, ``parallel/dryrun.py``,
the room-parallel driver) on the CPU, over gloo.

One group of ranks is spawned per world size (2 and 4; the group of 4 also
makes the 2 x 2 mesh), meets through a ``FileStore`` in ``tmp_path`` and is
joined with a timeout; every rank runs every check and writes its results.
Held against them, in this process:

- the culled and brute backends: the port's one-device result and the JAX
  functions on the conftest's virtual 8-device mesh (``backend="xla"``),
  both bit for bit (t, tri_id, hit, points, normals);
- the pair backend: the raycast contract against the oracle (hit masks and
  triangles agree on >= 99 % of rays, hit points within 5 mm at p99 and 5 cm
  at most);
- ``scan_waypoints_sharded`` (an 8-line profile, and the dual-axis profile
  with dropout and range noise drawn per rank from the same seed):
  ``scan_waypoints`` bit for bit;
- ``sharded_grid_nn``: the port's one-device grid 1-NN, index for index;
- the simulator's ``multichip`` branch: the one-device scan bit for bit.

``run_scenes_device_parallel`` on two CPU "devices" must write the files of
the sequential ``main``, the clouds byte for byte.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu_torch.containers import TriMesh  # noqa: E402
from ipcgen_tpu_torch.models.lidar_intrinsics import (  # noqa: E402
    DualAxisLidarIntrinsics,
    Indoor8LineLidarIntrinsics,
)
from ipcgen_tpu_torch.ops.raycast import raycast_asset  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_arrays, scene_asset_from_numpy  # noqa: E402
from ipcgen_tpu_torch.parallel import dryrun as port_dryrun  # noqa: E402
from ipcgen_tpu_torch.parallel import shard  # noqa: E402
from ipcgen_tpu_torch.sim.scan import scan_waypoints  # noqa: E402
from ipcgen_tpu_torch.trajectory import Waypoint  # noqa: E402
from ipcgen_tpu_torch.trajectory.waypoint import waypoints_to_pose_batch  # noqa: E402
from ipcgen_tpu_torch.utils.synthetic import synthetic_room  # noqa: E402

GOLDEN = Path(__file__).parent / "fixtures" / "golden_room"
BACKENDS = ("culled", "brute", "pairs")
FIELDS = ("t", "tri_id", "hit", "points", "normals")
GROUP_TIMEOUT_S = 240.0


def scene_arrays():
    """A 1,536-triangle room in 16-triangle blocks: 96 blocks, 12 supers of 8,
    so 2 and 4 shards cut it without padding and 8 (JAX) with."""
    v, t = synthetic_room(2000, seed=3)
    return build_scene_arrays(v, t, block_size=16, super_factor=8)


def rays(n=333, seed=0):
    rng = np.random.default_rng(seed)
    origins = np.tile(np.array([2.0, 1.5, 1.25], np.float32), (n, 1))
    origins += rng.uniform(-0.5, 0.5, origins.shape).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins, dirs


def profiles():
    eight = Indoor8LineLidarIntrinsics(vertical_res=4, horizontal_res=64,
                                       vertical_degrees=[10, 0, -10, -20], max_range=20.0)
    dual = DualAxisLidarIntrinsics.create_blk2go_dual_axis()
    dual.point_rate = 64_000  # 6,400 rays a waypoint
    dual.range_noise_std = 0.02
    return {"eight": eight, "dual": dual}


POSES = waypoints_to_pose_batch([Waypoint(2.0, 1.5, 1.0, 0.0), Waypoint(1.0, 1.0, 1.0, 1.0),
                                 Waypoint(3.0, 2.0, 1.2, 2.5)])


def result_arrays(res) -> dict:
    return {k: getattr(res, k).numpy() for k in FIELDS}


def _group_checks(rank: int, world_size: int, out_dir: str) -> None:
    """Every check of one group, on every rank; rank r writes rank_r.npz."""
    torch.set_num_threads(1)
    asset = scene_asset_from_numpy(scene_arrays(), "cpu")
    o, d = rays()
    out = {}
    meshes = {"rays": shard.make_device_mesh(), "tris": shard.make_device_mesh(
        axis_names=("tris",))}
    if world_size == 4:
        meshes["2d"] = shard.make_device_mesh(axis_names=("rays", "tris"))
        assert tuple(meshes["2d"].shape) == (2, 2)
    for backend in BACKENDS:
        for kind, mesh in meshes.items():
            fn = {"rays": shard.sharded_raycast_rays, "tris": shard.sharded_raycast_tris,
                  "2d": shard.sharded_raycast_2d}[kind]
            for k, x in result_arrays(fn(o, d, asset, mesh, backend=backend)).items():
                out[f"{kind}/{backend}/{k}"] = x
    for name, intr in profiles().items():
        for backend in ("culled", "pairs"):
            b = shard.scan_waypoints_sharded(
                asset, intr, POSES, meshes["rays"], backend=backend, apply_range_noise=True,
                generator=torch.Generator().manual_seed(5))
            for k in ("points", "t", "mask", "incident_angles", "normals"):
                out[f"scan/{name}/{backend}/{k}"] = getattr(b, k).numpy()
    rng = np.random.default_rng(1)
    refs = rng.uniform(0, 5, (8000, 3)).astype(np.float32)
    refs[:, 2] *= 0.5
    queries = rng.uniform(0, 5, (3001, 3)).astype(np.float32)
    out["grid_nn"] = shard.sharded_grid_nn(queries, refs, meshes["rays"], q_block=128)

    # The simulator's multichip branch against the one-device scan.
    from ipcgen_tpu_torch.sim.simulator import S3DISSimulator

    mesh_path = Path(out_dir) / f"room_{rank}.ply"
    TriMesh.box(center=(2.0, 1.5, 1.2), size=(4.0, 3.0, 2.4), inward=True).save(mesh_path)
    batches = []
    for multichip in (True, False):
        sim = S3DISSimulator({"raycast_engine": {"multichip": multichip}, "seed": 0,
                              "lidar": {"horizontal_res": 64}},
                             use_dense_lidar=True, device="cpu")
        sim.load_scene(str(mesh_path))
        waypoints, _ = sim.generate_auto_trajectory(3)
        batches.append(sim.dispatch_scan(waypoints))
    for k in ("points", "t", "mask"):
        assert torch.equal(getattr(batches[0], k), getattr(batches[1], k)), k
    np.savez(Path(out_dir) / f"rank_{rank}.npz", **out)


@pytest.fixture(scope="module", params=[2, 4])
def group(request, tmp_path_factory):
    """Spawn one gloo group of ``param`` ranks; every rank's results."""
    world_size = request.param
    out_dir = tmp_path_factory.mktemp(f"group{world_size}")
    port_dryrun.run_ranks(_group_checks, world_size, "gloo",
                          store_file=str(out_dir / "store"), args=(str(out_dir),),
                          timeout_s=GROUP_TIMEOUT_S)
    ranks = [dict(np.load(out_dir / f"rank_{r}.npz")) for r in range(world_size)]
    return world_size, ranks


def one_device(backend):
    asset = scene_asset_from_numpy(scene_arrays(), "cpu")
    o, d = rays()
    return result_arrays(raycast_asset(torch.from_numpy(o), torch.from_numpy(d), asset,
                                       backend=backend))


def kinds(world_size):
    return ("rays", "tris", "2d") if world_size == 4 else ("rays", "tris")


def test_every_rank_returns_the_same_result(group):
    world_size, ranks = group
    for r in ranks[1:]:
        assert set(r) == set(ranks[0])
        for k in ranks[0]:
            assert np.array_equal(r[k], ranks[0][k], equal_nan=True), k


@pytest.mark.parametrize("backend", ["culled", "brute"])
def test_exact_backends_equal_one_device_bit_for_bit(group, backend):
    world_size, ranks = group
    want = one_device(backend)
    for kind in kinds(world_size):
        for k in FIELDS:
            assert np.array_equal(ranks[0][f"{kind}/{backend}/{k}"], want[k]), (kind, k)


@pytest.mark.parametrize("backend", ["culled", "brute"])
def test_exact_backends_equal_the_jax_functions_on_eight_devices(group, backend):
    """The JAX package's sharded functions with ``backend="xla"`` on the
    virtual 8-device mesh (8 triangle shards pad the 96 blocks to 128)."""
    import jax

    from ipcgen_tpu.ops.scene_asset import SceneAsset as JaxAsset
    from ipcgen_tpu.parallel.shard import (
        make_device_mesh,
        sharded_raycast_2d,
        sharded_raycast_rays,
        sharded_raycast_tris,
    )

    assert len(jax.devices()) == 8
    world_size, ranks = group
    arrays = scene_arrays()
    jasset = JaxAsset(**{k: jax.numpy.asarray(v) if isinstance(v, np.ndarray) else v
                         for k, v in arrays.items()})
    o, d = rays()
    jax_runs = {
        "rays": sharded_raycast_rays(o, d, jasset, make_device_mesh(8, ("rays",)),
                                     backend="xla"),
        "tris": sharded_raycast_tris(o, d, jasset, make_device_mesh(8, ("tris",)),
                                     backend="xla"),
        "2d": sharded_raycast_2d(o, d, jasset, make_device_mesh(8, ("rays", "tris")),
                                 backend="xla"),
    }
    for kind in kinds(world_size):
        for k in FIELDS:
            want = np.asarray(getattr(jax_runs[kind], k))
            assert np.array_equal(ranks[0][f"{kind}/{backend}/{k}"], want), (kind, k)


def test_pair_backend_meets_the_raycast_contract(group):
    """Against the oracle, the raycast contract; against the one-device pair
    run, the same hit mask on every ray and no point over 5 cm: the edge
    test's float64 decisions do not depend on the centre each triangle
    shard's panels take."""
    world_size, ranks = group
    want = one_device("brute")
    one = one_device("pairs")
    for kind in kinds(world_size):
        hit, tri = ranks[0][f"{kind}/pairs/hit"], ranks[0][f"{kind}/pairs/tri_id"]
        points = ranks[0][f"{kind}/pairs/points"]
        both = hit & want["hit"]
        assert (hit == want["hit"]).mean() >= 0.99, kind
        assert (tri[both] == want["tri_id"][both]).mean() >= 0.99, kind
        err = np.linalg.norm(points[both] - want["points"][both], axis=1)
        assert np.percentile(err, 99) <= 5e-3 and err.max() <= 5e-2, kind
        assert np.array_equal(hit, one["hit"]), kind
        assert np.linalg.norm(points[hit] - one["points"][hit], axis=1).max() <= 5e-2, kind


@pytest.mark.parametrize("backend", ["culled", "pairs"])
@pytest.mark.parametrize("profile", ["eight", "dual"])
def test_sharded_scan_equals_scan_waypoints(group, profile, backend):
    world_size, ranks = group
    asset = scene_asset_from_numpy(scene_arrays(), "cpu")
    want = scan_waypoints(asset, profiles()[profile], POSES, backend=backend,
                          apply_range_noise=True, generator=torch.Generator().manual_seed(5))
    assert bool(want.mask.any())
    assert profile == "eight" or not bool(want.mask.all())  # the dual axis' dropout
    for k in ("points", "t", "mask", "incident_angles", "normals"):
        assert np.array_equal(ranks[0][f"scan/{profile}/{backend}/{k}"],
                              getattr(want, k).numpy()), k


def test_sharded_grid_nn_equals_the_one_device_1nn(group):
    from ipcgen_tpu_torch.ops.grid_nn import nearest_neighbor_indices_grid

    _, ranks = group
    rng = np.random.default_rng(1)
    refs = rng.uniform(0, 5, (8000, 3)).astype(np.float32)
    refs[:, 2] *= 0.5
    queries = rng.uniform(0, 5, (3001, 3)).astype(np.float32)
    want = nearest_neighbor_indices_grid(queries, refs, q_block=128, device="cpu")
    assert np.array_equal(ranks[0]["grid_nn"], want)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_shard_pieces_in_one_process_equal_the_unsharded_raycast(n_shards):
    """What ``chip_smoke.py`` runs on one card: S shard-local casts,
    globalised and combined in one process."""
    asset = scene_asset_from_numpy(scene_arrays(), "cpu")
    o, d = (torch.from_numpy(x) for x in rays())
    asset_p = shard.shard_asset_blocks(asset, n_shards)
    assert asset_p.num_blocks % (n_shards * asset.super_factor) == 0
    ts, slots = [], []
    for i in range(n_shards):
        t, s = shard.local_raycast(o, d, *shard.block_shard(asset_p, n_shards, i),
                                   super_factor=asset.super_factor, t_max=np.inf,
                                   backend="culled")
        ts.append(t)
        slots.append(shard.globalize_slots(s, i, asset_p.num_blocks // n_shards,
                                           asset.block_size))
    t, slot = shard.combine_nearest(torch.stack(ts), torch.stack(slots))
    want_t, want_slot = shard.local_raycast(
        o, d, asset.tri_data, asset.block_lo, asset.block_hi, asset.super_lo, asset.super_hi,
        super_factor=asset.super_factor, t_max=np.inf, backend="culled")
    assert torch.equal(t, want_t) and torch.equal(slot, want_slot)


def test_combine_takes_the_smallest_slot_on_a_tie():
    t_all = torch.tensor([[1.0, float("inf"), 2.0], [1.0, 3.0, 2.0], [0.5, 3.0, 2.0]])
    slot_all = torch.tensor([[4, -1, 7], [20, 30, 40], [50, 60, 70]], dtype=torch.int32)
    t, slot = shard.combine_nearest(t_all, slot_all)
    assert t.tolist() == [0.5, 3.0, 2.0] and slot.tolist() == [50, 30, 7]


def test_dryrun_at_world_size_two(tmp_path):
    port_dryrun.run_ranks(port_dryrun._rank_dryrun, 2, "gloo",
                          store_file=str(tmp_path / "store"),
                          args=(2, 0), timeout_s=GROUP_TIMEOUT_S)


def test_a_hung_rank_fails_its_test_within_the_timeout(tmp_path):
    with pytest.raises(TimeoutError):
        port_dryrun.run_ranks(_sleep, 2, "gloo", store_file=str(tmp_path / "store"),
                              timeout_s=10.0)


def _sleep(rank: int, world_size: int) -> None:
    import time

    if rank == 1:
        time.sleep(30)


def make_recon(root: Path) -> Path:
    recon = root / "reconstruction_results"
    for name, width in (("Area_1_office_1", 4.0), ("Area_1_office_2", 4.0)):
        (recon / name).mkdir(parents=True)
        TriMesh.box(center=(2.0, 1.5, 1.25), size=(width, 3.0, 2.5),
                    inward=True).save(recon / name / "mesh_dense.ply")
    return recon


def test_room_parallel_equals_the_sequential_driver(tmp_path):
    from ipcgen_tpu_torch.sim import simulator as psim

    recon = make_recon(tmp_path)
    root = tmp_path / "s3dis"
    for room in ("office_1", "office_2"):
        shutil.copytree(GOLDEN / "Area_1" / "office_1", root / "Area_1" / room)
        (root / "Area_1" / room / "office_1.txt").rename(root / "Area_1" / room / f"{room}.txt")
    scan = dict(num_waypoints=3, use_blk2go=False, use_dense_lidar=True,
                lidar_horizontal_res=128, s3dis_data_root=str(root))
    seq = psim.main(str(recon), output_base_dir=str(tmp_path / "seq"), use_gpu=False,
                    save_visualizations=False, device="cpu", **scan)
    jobs = [{"scene_path": p, "scene_name": n, "area": "Area_1", "room": n.split("_", 2)[2]}
            for p, n, _ in psim.find_available_scenes(str(recon))]
    ok, failed = psim.run_scenes_device_parallel(
        jobs, output_base_dir=str(tmp_path / "dp"), devices=["cpu", "cpu"], **scan)
    assert not failed and [n for n, _ in ok] == [n for n, _ in seq["successful"]]
    for name, _ in ok:
        for f in ("combined_pointcloud_with_label.ply", "combined_pointcloud.ply"):
            assert (tmp_path / "dp" / name / f).read_bytes() == \
                (tmp_path / "seq" / name / f).read_bytes(), (name, f)
        assert (tmp_path / "dp" / name / "trajectory_analysis.json").read_text() == \
            (tmp_path / "seq" / name / "trajectory_analysis.json").read_text()


def test_main_room_dp_runs_every_card(tmp_path, monkeypatch):
    """With more than one card, ``main(room_dp=True)`` hands the rooms that
    are not done yet to ``run_scenes_device_parallel`` (devices None: every
    card) with the skip rules of the sequential path."""
    from ipcgen_tpu_torch.sim import simulator as psim

    recon = make_recon(tmp_path)
    done = tmp_path / "out" / "Area_1_office_1"
    done.mkdir(parents=True)
    (done / "combined_pointcloud_with_label.ply").write_bytes(b"")
    (done / "simulation_statistics.txt").write_text("")
    calls = []

    def fake(jobs, **kwargs):
        calls.append((jobs, kwargs))
        return [(j["scene_name"], None) for j in jobs], []

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(psim, "run_scenes_device_parallel", fake)
    res = psim.main(str(recon), output_base_dir=str(tmp_path / "out"), room_dp=True)
    assert res["skipped"] == ["Area_1_office_1"]
    assert [n for n, _ in res["successful"]] == ["Area_1_office_2"]
    (jobs, kwargs), = calls
    assert jobs == [{"scene_path": str(recon / "Area_1_office_2" / "mesh_dense.ply"),
                     "scene_name": "Area_1_office_2", "area": "Area_1", "room": "office_2"}]
    assert "devices" not in kwargs and kwargs["save_visualizations"] is True
