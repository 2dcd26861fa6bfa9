"""Raycast: the port's oracle, prepass and candidate-pair path against the
JAX package.

On the CPU the pair path runs the kernel's plain PyTorch version (the CUDA
kernel has no CPU mode); tests/test_torch_cuda.py runs the kernel itself on
a card.  Tolerances:

- oracle vs JAX ``raycast_brute``: same hit mask, t within 1e-6 relative
  (both are float32 Moller-Trumbore; only summation order differs), the same
  triangle on >= 99.9 % of hit rays (exact ties may break differently);
- prepass: IDENTICAL ids/counts/overflow/masks (same float32 slab ops);
- pair path vs JAX mxu (interpret mode) and vs the oracle: the raycast
  contract of tests/test_tpu_hardware.py:234-258 (hit masks agree >= 99 %,
  same triangle >= 99 % of both-hit rays, hit-point error p99 <= 5 mm and
  max <= 5 cm): the Pluecker form rounds differently from Moller-Trumbore.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.ops import raycast as jax_raycast  # noqa: E402
from ipcgen_tpu.ops import raycast_mxu as jax_mxu  # noqa: E402
from ipcgen_tpu.ops.scene_asset import build_scene_asset as jax_build  # noqa: E402
from ipcgen_tpu_torch.ops import raycast_pairs as pairs  # noqa: E402
from ipcgen_tpu_torch.ops.raycast import (  # noqa: E402
    finalize_result,
    raycast_asset,
    raycast_brute,
)
from ipcgen_tpu_torch.ops.scene_asset import SceneAsset, build_scene_asset  # noqa: E402
from ipcgen_tpu_torch.utils.synthetic import cluttered_room  # noqa: E402

from test_torch_cuda import (  # noqa: E402
    contract,
    fuzz_check,
    np_res,
    t_,
)


def center_rays(rng, n, far_quarter=True):
    origins = np.tile(np.array([2, 1.5, 1.0], np.float32), (n, 1))
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    if far_quarter:
        origins[3 * n // 4:] = rng.uniform(-12, -6, (n // 4, 3)).astype(np.float32)
    return origins, dirs


def test_oracle_matches_jax_raycast_brute():
    rng = np.random.default_rng(0)
    verts, tris = cluttered_room(rng)
    corners = verts[tris]
    v0, e1, e2 = corners[:, 0], corners[:, 1] - corners[:, 0], corners[:, 2] - corners[:, 0]
    origins, dirs = center_rays(rng, 1024)
    tj, ij = map(np.asarray, jax_raycast.raycast_brute(origins, dirs, v0, e1, e2))
    tp, ip = raycast_brute(t_(origins), t_(dirs), t_(v0), t_(e1), t_(e2))
    tp, ip = tp.numpy(), ip.numpy()
    hit_j, hit_p = np.isfinite(tj), np.isfinite(tp)
    np.testing.assert_array_equal(hit_j, hit_p)
    np.testing.assert_allclose(tp[hit_p], tj[hit_j], rtol=1e-6)
    assert (ip[hit_p] == ij[hit_j]).mean() >= 0.999


@pytest.mark.parametrize(
    "kw",
    [
        dict(vmax=1024, group=8, gmax=48, tile=1024, n_sub=4),
        dict(vmax=16, group=4, gmax=6, tile=1024, n_sub=4),
        dict(vmax=64, group=2, gmax=64, tile=512, n_sub=2),
        dict(vmax=32, group=8, gmax=16, tile=256, n_sub=1),
    ],
)
def test_candidate_blocks_identical_to_jax(kw):
    """The scene and rays of tests/test_raycast_mxu.py:105-118 (one tile of
    center rays) plus far-origin rays, at several prepass shapes."""
    rng = np.random.default_rng(0)
    verts, tris = cluttered_room(rng)
    ja = jax_build(verts, tris, block_size=8, super_factor=2)
    pa = build_scene_asset(verts, tris, block_size=8, super_factor=2, device="cpu")
    origins, dirs = center_rays(rng, 2048)
    want = jax_mxu.candidate_blocks(origins, dirs, ja.block_lo, ja.block_hi,
                                    t_max=20.0, **kw)
    got = pairs.candidate_blocks(t_(origins), t_(dirs), pa.block_lo, pa.block_hi,
                                 t_max=20.0, **kw)
    for name, w, g in zip(("ids", "counts", "overflow", "masks"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_pairs_path_vs_jax_mxu_and_oracle():
    rng = np.random.default_rng(0)
    verts, tris = cluttered_room(rng)
    ja = jax_build(verts, tris)
    pa = build_scene_asset(verts, tris, device="cpu")
    origins, dirs = center_rays(rng, 2048)
    jm = jax_mxu.raycast_asset_mxu(origins, dirs, ja, t_max=20.0, interpret=True)
    po = raycast_asset(t_(origins), t_(dirs), pa, backend="brute", t_max=20.0)
    pp = raycast_asset(t_(origins), t_(dirs), pa, backend="pairs", t_max=20.0)
    hp, ip, xp, _ = np_res(pp)
    ho, io, xo, _ = np_res(po)
    contract(hp, np.asarray(jm.hit), ip, np.asarray(jm.tri_id), xp,
             np.asarray(jm.points))
    contract(hp, ho, ip, io, xp, xo)
    assert hp.sum() > 1024


def test_forced_overflow_walks_all_blocks():
    """Counterpart of tests/test_raycast_mxu.py:84: a prepass whose lists
    overflow (vmax = 2) sends every subtile down the walk-all branch, and the
    results still match the oracle."""
    rng = np.random.default_rng(0)
    verts, tris = cluttered_room(rng, n_boxes=3)
    asset = build_scene_asset(verts, tris, block_size=8, super_factor=2, device="cpu")
    assert asset.num_blocks > 2
    origins, dirs = center_rays(rng, 1024, far_quarter=False)
    o, d = t_(origins), t_(dirs)
    ids, counts, ovf, masks = pairs.candidate_blocks(
        o, d, asset.block_lo, asset.block_hi, t_max=1e30, vmax=2, tile=1024,
        n_sub=4)
    assert bool(ovf.all())
    offsets, blocks, walk_all = pairs.subtile_pairs(ids, counts, ovf, masks, 4)
    assert blocks.numel() == 0 and bool((walk_all == 1).all())
    center = (pairs._nanmin(asset.block_lo, 0) + pairs._nanmax(asset.block_hi, 0)) * 0.5
    t, slot = pairs.intersect_pairs(dict(
        f=pairs.ray_features(o - center, d), trif=pairs.build_trif(asset.tri_data, center),
        offsets=offsets, blocks=blocks, walk_all=walk_all, t_init=1e30, sub=256, origins=o,
        dirs=d, tri_data=asset.tri_data, radius=pairs.block_radius(asset.tri_data, center)))
    res = finalize_result(o, d, t, slot, asset)
    ref = raycast_asset(o, d, asset, backend="brute")
    hp, ip, xp, tp = np_res(res)
    ho, io, xo, to = np_res(ref)
    assert (hp == ho).mean() > 0.999
    both = hp & ho
    np.testing.assert_allclose(tp[both], to[both], rtol=1e-3)
    contract(hp, ho, ip, io, xp, xo)


def _hand_asset(tri_blocks):
    """Asset from explicit (NB, TB, 3, 3) corners; slots without a triangle
    are the asset build's far-away degenerate padding."""
    nb, tb = len(tri_blocks), len(tri_blocks[0])
    tri_data = np.zeros((nb, 16, tb), np.float32)
    tri_index = np.full(nb * tb, -1, np.int32)
    for b, blk in enumerate(tri_blocks):
        for k, c in enumerate(blk):
            if c is None:
                c = np.full((3, 3), 1e7, np.float32)
            else:
                tri_index[b * tb + k] = b * tb + k
            c = np.asarray(c, np.float32)
            tri_data[b, 0:3, k] = c[0]
            tri_data[b, 3:6, k] = c[1] - c[0]
            tri_data[b, 6:9, k] = c[2] - c[0]
    lo = np.array([[-1, -1, -1]] * nb, np.float32)
    hi = np.array([[5, 5, 5]] * nb, np.float32)
    fin = np.zeros((nb * tb, 4), np.float32)
    fin[:, 3] = tri_index.view(np.float32)
    tensors = dict(tri_data=tri_data, block_lo=lo, block_hi=hi, super_lo=lo[:1],
                   super_hi=hi[:1], tri_index=tri_index,
                   tri_normal=np.zeros((nb * tb, 3), np.float32), tri_fin=fin)
    return SceneAsset(**{k: t_(v) for k, v in tensors.items()}, n_tris=nb * tb,
                      block_size=tb, super_factor=1)


def test_padding_never_wins_and_ties_go_to_smallest_slot():
    tri = [[0, 0, 2], [4, 0, 2], [0, 4, 2]]
    pad = None
    # The same triangle at slot 5 (block 0) and slot 8 + 3 = 11 (block 1).
    asset = _hand_asset([[pad] * 5 + [tri] + [pad] * 2,
                         [pad] * 3 + [tri] + [pad] * 4])
    trif = pairs.build_trif(asset.tri_data)
    # Padded lanes: zero normal, so t_num = t_den = 0 (0/0 never passes).
    tden = trif[:, :, 4 * 8:].numpy()
    assert np.all(tden[0][:, [0, 1, 2, 3, 4, 6, 7]] == 0.0)
    origins = np.array([[1, 1, 0], [10, 10, 0]], np.float32)
    dirs = np.array([[0, 0, 1], [0, 0, 1]], np.float32)
    o = torch.cat([t_(origins), t_(origins)[-1:].expand(254, 3)])  # one 256-ray subtile
    d = torch.cat([t_(dirs), t_(dirs)[-1:].expand(254, 3)])
    f = pairs.ray_features(o, d)
    base = dict(f=f, trif=trif, t_init=1e30, sub=256, origins=o, dirs=d,
                tri_data=asset.tri_data,
                radius=pairs.block_radius(asset.tri_data, torch.zeros(3)))
    # The list walks block 1 first: the tie rule, not the walk order, decides.
    for blocks in ([1, 0], [0, 1]):
        t, slot = pairs.intersect_pairs(dict(
            base, offsets=torch.tensor([0, 2], dtype=torch.int32),
            blocks=torch.tensor(blocks, dtype=torch.int32),
            walk_all=torch.zeros(1, dtype=torch.int32)))
        assert slot[0].item() == 5 and abs(t[0].item() - 2.0) < 1e-6
        assert slot[1].item() == -1 and np.isinf(t[1].item())
    every = dict(base, offsets=torch.tensor([0, 0], dtype=torch.int32),
                 blocks=torch.zeros(0, dtype=torch.int32),
                 walk_all=torch.ones(1, dtype=torch.int32))
    t, slot = pairs.intersect_pairs(every)
    assert slot[0].item() == 5
    # The t_max cap is the initial best: a hit at t = 2 is dropped under 1.5.
    t, slot = pairs.intersect_pairs(dict(every, t_init=1.5))
    assert slot[0].item() == -1


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_oblique_degenerate_plain(seed):
    fuzz_check("cpu", seed)


def test_geometry_helpers_match_jax():
    """Moller-Trumbore (vector and component forms) and the slab test against
    ipcgen_tpu/ops/geometry.py on random rays and triangles: the same float32
    formulas, so hit masks agree exactly and t to 1e-6 relative."""
    from ipcgen_tpu.ops import geometry as jgeo
    from ipcgen_tpu_torch.ops import geometry as pgeo

    rng = np.random.default_rng(3)
    n = 4096
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    v0 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    e1 = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    e2 = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    want = np.asarray(jgeo.moller_trumbore(o, d, v0, e1, e2))
    for got in (
        pgeo.moller_trumbore(t_(o), t_(d), t_(v0), t_(e1), t_(e2)),
        pgeo.moller_trumbore_components(*[t_(a[:, k]) for a in (o, d, v0, e1, e2)
                                          for k in range(3)]),
    ):
        got = got.numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        hit = np.isfinite(want)
        assert hit.sum() > 100
        np.testing.assert_allclose(got[hit], want[hit], rtol=1e-6)
    lo = rng.uniform(-1, 0.5, 3).astype(np.float32)
    hi = lo + rng.uniform(0.2, 1.0, 3).astype(np.float32)
    lo_nan = np.array([np.nan, 0, 0], np.float32)
    inv = (1.0 / d).astype(np.float32)
    for box_lo, t_best in ((lo, 2.0), (lo_nan, 2.0), (lo, 0.3)):
        args = [o[:, 0], o[:, 1], o[:, 2], inv[:, 0], inv[:, 1], inv[:, 2]]
        want = np.asarray(jgeo.ray_aabb_hit(*args, tuple(box_lo), tuple(hi), t_best))
        got = pgeo.ray_aabb_hit(*[t_(a) for a in args], tuple(map(float, box_lo)),
                                tuple(map(float, hi)), t_best).numpy()
        np.testing.assert_array_equal(got, want)
        if box_lo is lo_nan:
            assert not got.any()  # a NaN box never passes


def test_engines_hit_the_box_room_walls():
    """``RaycastEngineCPU`` (oracle) and the pair path agree on the box room
    and every hit lies on a wall plane (the JAX engine test's check)."""
    from ipcgen_tpu.containers import TriMesh
    from ipcgen_tpu_torch.sim.engine import RaycastEngineCPU, RaycastEngineGPU

    room = TriMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)
    rng = np.random.default_rng(4)
    d = rng.normal(size=(512, 3))
    rays = np.concatenate([np.tile([2.0, 1.5, 1.0], (512, 1)), d], axis=1)
    pts_cpu = RaycastEngineCPU().rays_intersect_mesh(rays, room)
    pts_pairs = RaycastEngineGPU(device="cpu").rays_intersect_mesh(rays, room)
    assert len(pts_cpu) == len(pts_pairs) == 512
    np.testing.assert_allclose(pts_pairs, pts_cpu, atol=1e-4)
    on_wall = np.zeros(512, bool)
    for axis, vals in ((0, (0.0, 4.0)), (1, (0.0, 3.0)), (2, (0.0, 2.5))):
        for v in vals:
            on_wall |= np.isclose(pts_cpu[:, axis], v, atol=1e-3)
    assert on_wall.all()
    with pytest.raises(ValueError):
        RaycastEngineCPU().rays_intersect_mesh(rays[:, :3], room)


@pytest.mark.parametrize("max_range", [20.0, 2.0])
def test_lidar_intersect_mesh_matches_the_jax_engine(max_range):
    """``lidar_intersect_mesh`` (a LiDAR's rays, the range cut, incident
    angles from the vertical) of the port's oracle engine against the JAX
    CPU engine on the box room: the same points within 1e-4 m (float32
    Moller-Trumbore in both, summed in another order) and the same angles
    within 1e-3 degrees; a 2 m range drops most hits on both sides."""
    from ipcgen_tpu.containers import TriMesh as JaxMesh
    from ipcgen_tpu.models import Indoor8LineLidarIntrinsics as JaxIntrinsics
    from ipcgen_tpu.models import create_lidar as jax_lidar
    from ipcgen_tpu.sim.engine import RaycastEngineCPU as JaxEngine
    from ipcgen_tpu_torch.containers import TriMesh
    from ipcgen_tpu_torch.models import Indoor8LineLidarIntrinsics, create_lidar
    from ipcgen_tpu_torch.sim.engine import RaycastEngineCPU, RaycastEngineGPU
    from ipcgen_tpu_torch.trajectory import Waypoint

    kw = dict(vertical_res=4, horizontal_res=64, vertical_degrees=[10, 0, -10, -20],
              max_range=max_range)
    pose = Waypoint(2.0, 1.5, 1.0, 0.3).to_pose_matrix()
    box = dict(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)
    want_pts, want_ang = JaxEngine().lidar_intersect_mesh(
        jax_lidar(JaxIntrinsics(**kw), pose), JaxMesh.box(**box))
    lidar = create_lidar(Indoor8LineLidarIntrinsics(**kw), pose, device="cpu")
    for engine in (RaycastEngineCPU(), RaycastEngineGPU(device="cpu")):
        pts, ang = engine.lidar_intersect_mesh(lidar, TriMesh.box(**box))
        assert len(pts) == len(want_pts) == len(ang) > 0
        np.testing.assert_allclose(pts, want_pts, atol=1e-4)
        np.testing.assert_allclose(ang, want_ang, atol=1e-3)
    assert (len(want_pts) < 256) == (max_range < 3)
