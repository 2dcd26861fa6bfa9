"""The culled Moller-Trumbore raycast (the JAX package's "pallas"/"xla"
backend): the port's plain version against the JAX Pallas kernel in
interpret mode and its XLA twin, the port's block-scan oracle against JAX
``xla_brute``, the kernel's build, and the config route that selects it.

On the CPU the culled path runs the kernel's plain PyTorch version (the CUDA
kernel has no CPU mode); tests/test_torch_cuda.py runs the kernel itself on a
card.  Tolerances:

- plain version vs the port's oracle: t, tri_id, hit, points and normals bit
  for bit (the hardware contract of tests/test_tpu_hardware.py:57-70, moved to
  the port): the same float32 component arithmetic, each operation rounded
  on its own, and culling only skips blocks a ray cannot enter;
- plain version and oracle vs JAX: hit masks and tri_id identical, t within
  1e-6 relative.  XLA on the CPU may round a fused expression differently
  from torch's one-operation-at-a-time arithmetic, so bit equality is not
  asked across the two frameworks, and where a ray runs nearly parallel to
  the plane of the triangle it hits, that rounding is amplified by the hit's
  condition number |e1| |e2| / |det|: there the bound is one float32 unit
  roundoff times that number (the soup has one such ray, at about 0.3
  degrees to the plane: condition 200, the two t differ by 5.4e-6);
- the kernel's prescreen (its torch copy ``mt_prescreen_plain``): no test
  that exact Moller-Trumbore accepts at t <= best may be rejected, on seeded
  fuzz and a hypothesis property; the visit floors: ordered as their group
  sizes require.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.containers import TriMesh  # noqa: E402
from ipcgen_tpu.ops import raycast as jax_raycast  # noqa: E402
from ipcgen_tpu.ops.raycast_pallas import raycast_pallas_components  # noqa: E402
from ipcgen_tpu.ops.scene_asset import build_scene_asset as jax_build  # noqa: E402
from ipcgen_tpu_torch.ops import _kernels  # noqa: E402
from ipcgen_tpu_torch.ops import raycast_culled as culled  # noqa: E402
from ipcgen_tpu_torch.ops.geometry import moller_trumbore_components  # noqa: E402
from ipcgen_tpu_torch.ops import raycast_backends  # noqa: E402
from ipcgen_tpu_torch.ops.raycast import raycast_asset  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset  # noqa: E402
from ipcgen_tpu_torch.sim import simulator as port_sim  # noqa: E402

from ipcgen_tpu_torch.utils.synthetic import culled_edge_cases, hardware_scene  # noqa: E402
from test_torch_cuda import same_result, t_, t_max_scene  # noqa: E402


def soup_case():
    """tests/test_raycast.py:85-90: 60 random triangles, 257 random rays."""
    rng = np.random.default_rng(0)
    base = rng.uniform(-5, 5, size=(60, 3))
    verts = np.concatenate([base, base + rng.normal(0, 1, (60, 3)),
                            base + rng.normal(0, 1, (60, 3))]).astype(np.float32)
    tris = np.arange(180, dtype=np.int32).reshape(3, 60).T
    origins = rng.uniform(-5, 5, size=(257, 3)).astype(np.float32)
    dirs = rng.normal(size=(257, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return verts, tris, origins, dirs, dict(block_size=16, super_factor=4), np.inf


def box_case(t_max):
    """The box room of tests/test_raycast.py:103-137 (block_size 8): 400
    level rays from the centre (walls 1.5-2.5 m away) and 256 random ones."""
    room = TriMesh.box(center=(2.0, 1.5, 1.25), size=(4.0, 3.0, 2.5), inward=True)
    phis = np.linspace(0, 2 * np.pi, 400, endpoint=False)
    level = np.stack([np.cos(phis), np.sin(phis), np.zeros(400)], axis=1)
    rng = np.random.default_rng(1)
    rand = rng.normal(size=(256, 3))
    dirs = np.concatenate([level, rand / np.linalg.norm(rand, axis=1, keepdims=True)])
    origins = np.tile(np.array([2.0, 1.5, 1.25]), (len(dirs), 1))
    return (room.vertices.astype(np.float32), room.triangles.astype(np.int32),
            origins.astype(np.float32), dirs.astype(np.float32),
            dict(block_size=8, super_factor=8), t_max)


def cluttered_case():
    """The cluttered room of tests/test_tpu_hardware.py:31-50 at 2,048 rays,
    a quarter of them from outside; leaf blocks of 8 so culling has work."""
    verts, tris, origins, dirs = hardware_scene(2048)
    return verts, tris, origins, dirs, dict(block_size=8, super_factor=2), 20.0


CASES = {
    "soup": soup_case,
    "box_t1": lambda: box_case(1.0),
    "box_t3": lambda: box_case(3.0),
    "cluttered": cluttered_case,
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    verts, tris, origins, dirs, kw, t_max = CASES[request.param]()
    ja = jax_build(verts, tris, **kw)
    pa = build_scene_asset(verts, tris, device="cpu", **kw)
    o, d = t_(origins), t_(dirs)
    slots = culled.raycast_culled_components(
        o, d, pa.tri_data, pa.block_lo, pa.block_hi, pa.super_lo, pa.super_hi,
        super_factor=pa.super_factor, t_max=t_max)
    return dict(name=request.param, ja=ja, origins=origins, dirs=dirs,
                t_max=t_max, slots=slots,
                culled=raycast_asset(o, d, pa, backend="culled", t_max=t_max),
                brute=raycast_asset(o, d, pa, backend="brute", t_max=t_max))


def condition(tri_data, slot, dirs):
    """|e1| |e2| / |det| of each hit (float64), from its packed triangle."""
    tri = np.asarray(tri_data, np.float64)
    nb, _, tb = tri.shape
    comp = tri[:, :9, :].transpose(0, 2, 1).reshape(nb * tb, 9)[slot]
    e1, e2 = comp[:, 3:6], comp[:, 6:9]
    det = np.einsum("ij,ij->i", e1, np.cross(np.asarray(dirs, np.float64), e2))
    return np.linalg.norm(e1, axis=1) * np.linalg.norm(e2, axis=1) / np.abs(det)


def assert_like_jax(t_jax, slot_jax, t_port, slot_port, tri_data, dirs):
    """Hit masks and slots identical; t within 1e-6 relative, or one unit
    roundoff times the hit's condition number where that is larger."""
    t_jax, slot_jax = np.asarray(t_jax), np.asarray(slot_jax)
    t_port, slot_port = np.asarray(t_port), np.asarray(slot_port)
    np.testing.assert_array_equal(np.isfinite(t_port), np.isfinite(t_jax))
    np.testing.assert_array_equal(slot_port, slot_jax)
    hit = np.isfinite(t_jax)
    cond = condition(tri_data, slot_jax[hit], np.asarray(dirs)[hit])
    rtol = np.maximum(1e-6, np.finfo(np.float32).eps * cond)
    rel = np.abs(t_port[hit] - t_jax[hit]) / np.abs(t_jax[hit])
    assert np.all(rel <= rtol), (rel.max(), rtol[np.argmax(rel / rtol)])


def test_plain_matches_jax_pallas_and_xla(case):
    """Packed slots compare directly: the two builds give identical asset
    arrays (tests/test_torch_scene_asset.py)."""
    ja = case["ja"]
    kw = dict(block_size=ja.block_size, super_factor=ja.super_factor,
              t_max=case["t_max"])
    comps = (ja.tri_data, ja.block_lo, ja.block_hi, ja.super_lo, ja.super_hi)
    tp, sp = raycast_pallas_components(case["origins"], case["dirs"], *comps,
                                       interpret=True, **kw)
    tx, sx = jax_raycast.raycast_xla_culled_components(
        case["origins"], case["dirs"], *comps, **kw)
    for t_jax, slot_jax in ((tp, sp), (tx, sx)):
        assert_like_jax(t_jax, slot_jax, *case["slots"], ja.tri_data, case["dirs"])


def test_plain_bit_exact_against_oracle(case):
    same_result(case["culled"], case["brute"])
    hits = case["culled"].hit.float().mean().item()
    if case["name"] == "box_t1":
        assert hits == 0.0  # every wall is at least 1.25 m away
    else:
        assert hits > 0.05


def test_oracle_matches_jax_xla_brute(case):
    ref = jax_raycast.raycast_asset(case["origins"], case["dirs"], case["ja"],
                                    backend="xla_brute", t_max=case["t_max"])
    res = case["brute"]
    np.testing.assert_array_equal(res.tri_id.numpy(), np.asarray(ref.tri_id))
    # The oracle's packed slots, from its t and tri_id, as the JAX side's.
    t_slot = jax_raycast._raycast_asset_xla_core(case["origins"], case["dirs"],
                                                 case["ja"])
    slot = np.where(np.asarray(ref.hit), np.asarray(t_slot[1]), -1)
    assert_like_jax(ref.t, slot, res.t, slot, case["ja"].tri_data, case["dirs"])


def test_t_max_cull_and_ties():
    """A hit at exactly t_max is dropped by both the culled path and the
    oracle, and kept under the next float up; the tie between the same
    triangle in two leaf blocks goes to the smaller slot."""
    verts, tris, origins, dirs = t_max_scene()
    asset = build_scene_asset(verts, tris, block_size=1, super_factor=2, device="cpu")
    o, d = t_(origins), t_(dirs)
    up = float(np.nextafter(np.float32(2), np.float32(3)))
    for t_max, hit in ((2.0, False), (up, True), (np.inf, True)):
        res = raycast_asset(o, d, asset, backend="culled", t_max=t_max)
        same_result(res, raycast_asset(o, d, asset, backend="brute", t_max=t_max))
        assert res.hit.tolist() == [hit, False]
        if hit:
            assert res.t[0].item() == 2.0
            assert res.tri_id[0].item() == asset.tri_index[0].item()


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """CPU tensors reach the plain version and launch nothing; a tensor on
    another device raises; the kernel wrapper refuses CPU tensors."""
    verts, tris, origins, dirs = hardware_scene(256)
    asset = build_scene_asset(verts, tris, device="cpu")
    calls = []
    plain = culled.raycast_culled_plain
    monkeypatch.setattr(culled, "raycast_culled_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    before = dict(_kernels.LAUNCHES)
    raycast_asset(t_(origins), t_(dirs), asset, backend="culled")
    assert calls == [1] and _kernels.LAUNCHES == before
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError):
        culled.raycast_culled_components(
            meta, meta, asset.tri_data.to("meta"), *(torch.empty((1, 3), device="meta"),) * 4,
            super_factor=asset.super_factor)
    comps = (asset.tri_data, asset.block_lo, asset.block_hi, asset.super_lo,
             asset.super_hi)
    with pytest.raises(ValueError):
        _kernels.raycast_culled_cuda(t_(origins), t_(dirs), *comps,
                                     asset.super_factor, 1e30)


@pytest.mark.parametrize("name", list(_kernels.SOURCES))
def test_kernel_build_commands(name):
    """Each source builds on its own for sm_90a, never with fast math; the
    culled source without FMA contraction."""
    cmd = _kernels.nvcc_command(name, _kernels.BUILD_DIR / "x.so")
    assert (_kernels.CSRC / f"{name}.cu").is_file()
    assert cmd[-1].endswith(f"csrc/{name}.cu")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    if name == "raycast_culled":
        assert "-fmad=false" in cmd
        src = (_kernels.CSRC / f"{name}.cu").read_text()
        assert "__frcp" not in src and "__fdividef" not in src
        # The kernel's rays per CUDA block are the plain version's groups.
        assert f"constexpr int kGroup = {culled.GROUP};" in src
    lib = _kernels._library_path(name)
    assert lib.parent == _kernels.BUILD_DIR and name in lib.name
    assert len({_kernels._library_path(n) for n in _kernels.SOURCES}) == len(_kernels.SOURCES)


# ---------------------------------------------------------------------------
# The config route
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name, want", sorted(raycast_backends.RAYCAST_BACKENDS.items()))
def test_config_backend_names(name, want):
    assert raycast_backends.port_backend(name) == want
    sim = port_sim.S3DISSimulator({"raycast_engine": {"backend": name}}, device="cpu")
    assert sim.backend == want


def test_unknown_config_backend_raises():
    with pytest.raises(ValueError, match="unknown raycast backend"):
        raycast_backends.port_backend("embree")
    with pytest.raises(ValueError):
        port_sim.S3DISSimulator({"raycast_engine": {"backend": "cuda"}}, device="cpu")
    # The config takes the JAX package's names only, not the port's.
    with pytest.raises(ValueError, match="unknown raycast backend"):
        port_sim.S3DISSimulator({"raycast_engine": {"backend": "culled"}}, device="cpu")


def test_default_config_gives_pairs():
    assert port_sim.load_default_config()["simulation"]["backend"] == "auto"
    # "auto" is the culled kernel (the JAX package's "xla" off the TPU).
    assert port_sim.create_simulator_from_config(device="cpu").backend == "culled"
    assert port_sim.S3DISSimulator({}, device="cpu").backend == "culled"
    assert port_sim.S3DISSimulator({"raycast_engine": {"backend": "mxu"}},
                                   device="cpu").backend == "pairs"


def test_yaml_pallas_config_reaches_the_culled_path(tmp_path, monkeypatch):
    """``create_simulator_from_config`` on a YAML tree with
    ``simulation.backend: pallas``: the scan goes through
    ``raycast_culled_components``, in beam order."""
    import yaml

    from ipcgen_tpu.trajectory import Waypoint

    cfg = tmp_path / "sim.yaml"
    cfg.write_text(yaml.safe_dump({
        "simulation": {"backend": "pallas", "use_blk2go": False, "seed": 3},
        "data": {"data_root": str(tmp_path), "area_name": None, "room_name": None},
    }))
    sim = port_sim.create_simulator_from_config(str(cfg), device="cpu")
    assert sim.backend == "culled" and sim.config["seed"] == 3
    mesh = tmp_path / "mesh_dense.ply"
    TriMesh.box(center=(2.0, 1.5, 1.2), size=(4.0, 3.0, 2.4), inward=True).save(mesh)
    sim.load_scene(str(mesh))
    seen = []
    real = culled.raycast_culled_components
    monkeypatch.setattr(culled, "raycast_culled_components",
                        lambda *a, **k: seen.append(a[0].shape[0]) or real(*a, **k))
    waypoints = [Waypoint(1.5, 1.5, 1.0, 0.0), Waypoint(2.5, 1.2, 1.0, 1.0)]
    batch = sim.dispatch_scan(waypoints)
    rays = sim.lidar_config.get_total_points_per_scan()
    assert seen == [2 * rays]
    assert batch.mask.all()  # a closed box: every ray hits


# ---------------------------------------------------------------------------
# The edge-case set, the prescreen and the visit floors
# ---------------------------------------------------------------------------
def all_slot_t(o, d, tri_data, t_max):
    """Moller-Trumbore of every ray against every packed slot, hits at or
    beyond t_max dropped: (R, NB * TB)."""
    comp = tri_data[:, :9, :].permute(1, 0, 2).reshape(9, -1)
    t = moller_trumbore_components(*(o[:, i, None] for i in range(3)),
                                   *(d[:, i, None] for i in range(3)),
                                   *(comp[k][None, :] for k in range(9)))
    return torch.where(t < t_max, t, torch.full_like(t, float("inf")))


def super_entry(o, d, lo, hi):
    """float64 entry distance of each ray into one box (inf on a miss)."""
    o, d = np.asarray(o, np.float64), np.asarray(d, np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        t1, t2 = (lo - o) / d, (hi - o) / d
    tmin = np.nanmax(np.minimum(t1, t2), axis=-1)
    tmax = np.nanmin(np.maximum(t1, t2), axis=-1)
    return np.where(tmax >= np.maximum(tmin, 0), np.maximum(tmin, 0), np.inf)


@pytest.fixture(scope="module")
def edge():
    verts, tris, origins, dirs, kw, t_max = culled_edge_cases()
    asset = build_scene_asset(verts, tris, device="cpu", **kw)
    o, d = t_(origins), t_(dirs)
    return dict(verts=verts, tris=tris, origins=origins, dirs=dirs, kw=kw, t_max=t_max,
                asset=asset, o=o, d=d,
                culled=raycast_asset(o, d, asset, backend="culled", t_max=t_max),
                brute=raycast_asset(o, d, asset, backend="brute", t_max=t_max))


def test_edge_cases_plain_matches_oracle_and_jax(edge):
    """The plain version at the kernel's group equals the oracle bit for bit
    and JAX's xla_brute (hit masks and triangles identical, t within the
    module's condition-scaled bound: the tie rays cross their triangles at
    all angles) on the edge-case set."""
    same_result(edge["culled"], edge["brute"])
    ja = jax_build(edge["verts"], edge["tris"], **edge["kw"])
    ref = jax_raycast.raycast_asset(edge["origins"], edge["dirs"], ja, backend="xla_brute",
                                    t_max=edge["t_max"])
    res = edge["culled"]
    np.testing.assert_array_equal(res.tri_id.numpy(), np.asarray(ref.tri_id))
    asset = edge["asset"]
    t, slot = culled.raycast_culled_components(
        edge["o"], edge["d"], asset.tri_data, asset.block_lo, asset.block_hi,
        asset.super_lo, asset.super_hi, super_factor=asset.super_factor,
        t_max=edge["t_max"])
    t_ref = np.where(np.asarray(ref.hit), np.asarray(ref.t), np.inf)
    assert_like_jax(t_ref, slot, t, slot, asset.tri_data, edge["dirs"])


def test_edge_cases_hold_what_they_promise(edge):
    """Ties across blocks (some with the smaller slot in the super entered
    later), t_max hits, |det| at 1e-9 and stacked hits are all in the set,
    and each came out as the tie rule and the guards say."""
    asset, o, d, res = edge["asset"], edge["o"], edge["d"], edge["culled"]
    tb = asset.tri_data.shape[2]
    sf = asset.super_factor
    t_all = all_slot_t(o, d, asset.tri_data, edge["t_max"])
    t_min = t_all.min(dim=1).values
    tied = (t_all == t_min[:, None]) & torch.isfinite(t_min)[:, None]
    later = 0
    for r in torch.nonzero(tied.sum(1) > 1).flatten().tolist():
        slots = torch.nonzero(tied[r]).flatten()
        assert res.hit[r] and slots.min().item() // tb < slots.max().item() // tb
        # The winner is the smallest tied slot (its original id).
        assert res.tri_id[r].item() == asset.tri_index[slots.min()].item()
        supers = slots // (tb * sf)
        entry = super_entry(edge["origins"][r], edge["dirs"][r],
                            asset.super_lo[supers].numpy(), asset.super_hi[supers].numpy())
        later += bool(entry[0] > entry.min())
    assert later > 0
    n_dup = 12 * 24
    # Rays along +z: t = t_max is dropped, one step below is kept.
    t_rays = n_dup + 7
    assert not res.hit[t_rays] and res.hit[t_rays + 2]
    assert res.t[t_rays + 2].item() == float(np.nextafter(np.float32(6), np.float32(0)))
    # Thin triangles: a hit exactly when the width (= |det|) exceeds 1e-9f.
    widths = [edge["verts"][3 * i + 1, 0] for i in range(62, 69)]
    assert res.hit[n_dup:n_dup + 7].tolist() == [w > np.float32(1e-9) for w in widths]
    # Stacked triangles: the nearest, at exactly z = 3 on the +z rays.
    stacked = n_dup + 11
    assert res.t[stacked:stacked + 3].tolist() == [3.0] * 3
    assert res.hit[stacked:stacked + 9].all()


def prescreen_cases(n: int, seed: int):
    """Seeded ray-triangle pairs (15 float32 (n,) components) and a best for
    each.  Rays aim at a point near the triangle (barycentrics in
    [-0.05, 1.05]) from 1 mm to 20 m away; edges of 1 m, 1 cm or 0.1 mm.
    Quarters: as drawn; e1 scaled so |det| is within 0.1 % of 1e-9; best
    0 to 4 float32 steps either side of the pair's own t; the origin 0.1 to
    10 um before the plane, so t_num is near zero and t near t_min."""
    rng = np.random.default_rng(seed)
    f = np.float32
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(f)
    v0 = rng.normal(size=(n, 3)).astype(f)
    scale = rng.choice([1.0, 1e-2, 1e-4], size=(n, 1))
    e1 = (rng.normal(size=(n, 3)) * scale).astype(f)
    e2 = (rng.normal(size=(n, 3)) * scale).astype(f)
    q = n // 4
    det = np.einsum("ij,ij->i", e1.astype(np.float64),
                    np.cross(d.astype(np.float64), e2.astype(np.float64)))
    e1[:q] *= (1e-9 * rng.uniform(0.999, 1.001, (q, 1))
               / np.maximum(np.abs(det[:q, None]), 1e-30)).astype(f)
    u, v = rng.uniform(-0.05, 1.05, (2, n, 1))
    target = v0 + u * e1 + v * e2
    t0 = rng.uniform(1e-3, 20.0, (n, 1))
    t0[3 * q:] = rng.uniform(1e-7, 1e-5, (n - 3 * q, 1))
    o = (target - t0 * d).astype(f)
    comps = [torch.from_numpy(np.ascontiguousarray(a[:, i]))
             for a in (o, d, v0, e1, e2) for i in range(3)]
    t = moller_trumbore_components(*comps)
    best = torch.from_numpy(rng.uniform(0.5, 30.0, n).astype(f))
    near = torch.where(torch.isfinite(t), t, best)
    steps = torch.from_numpy(rng.integers(-4, 5, n))
    toward = torch.where(steps > 0, torch.full_like(near, np.inf), torch.zeros_like(near))
    for k in range(4):
        near = torch.where(steps.abs() > k, torch.nextafter(near, toward), near)
    part = (torch.arange(n) >= 2 * q) & (torch.arange(n) < 3 * q)
    # Clearly outside: 1 % of an edge on 1 m triangles (the origin's rounding
    # moves u and v by about 1e-6 there), |det| not shrunk to 1e-9.
    outside = torch.from_numpy(((u < -0.01) | (v < -0.01))[:, 0] & (scale[:, 0] == 1.0))
    outside[:q] = False
    return comps, torch.where(part, near, best), outside


def check_prescreen(comps, best):
    t = moller_trumbore_components(*comps)
    accepted = torch.isfinite(t) & (t <= best)
    keep = culled.mt_prescreen_plain(*comps, best)
    missed = accepted & ~keep
    assert not missed.any(), (int(missed.sum()), torch.nonzero(missed)[:5].flatten())
    return accepted, keep


@pytest.mark.parametrize("seed", [0, 1])
def test_prescreen_never_rejects_an_accepted_hit(seed):
    """128 k seeded pairs with near-threshold cases: every test that exact
    Moller-Trumbore accepts at t <= best survives the prescreen, and no hit
    beyond best by 1e-5 relative, nor a ray clearly outside, does."""
    comps, best, outside = prescreen_cases(1 << 17, seed)
    accepted, keep = check_prescreen(comps, best)
    assert accepted.sum() > 10_000
    # Not vacuous: a hit beyond best by 1e-5 relative, and a ray aimed 1 %
    # of an edge outside the triangle, never reach the divide.
    t = moller_trumbore_components(*comps)
    far = torch.isfinite(t) & (t > best * (1 + 1e-5))
    assert far.sum() > 1000 and not keep[far].any()
    assert outside.sum() > 1000 and not keep[outside].any()


def test_prescreen_on_exact_best_ties():
    """best equal to the pair's own t (a tie) and one float step either
    side: the prescreen keeps the test whenever t <= best."""
    comps, _, _ = prescreen_cases(1 << 14, 2)
    t = moller_trumbore_components(*comps)
    hit = torch.isfinite(t)
    for best in (t, torch.nextafter(t, torch.full_like(t, np.inf)),
                 torch.nextafter(t, torch.zeros_like(t))):
        b = torch.where(hit, best, torch.ones_like(t))
        check_prescreen(comps, b)


f32s = st.floats(-8.0, 8.0, width=32, allow_subnormal=False)


@settings(max_examples=400, deadline=None, derandomize=True)
@given(st.lists(f32s, min_size=12, max_size=12), st.floats(-0.1, 1.1), st.floats(-0.1, 1.1),
       st.floats(1e-7, 100.0), st.sampled_from([1.0, 1e-3, 1e-5]), st.integers(-3, 3),
       st.floats(float(np.float32(1e-5)), float(np.float32(3e38)), width=32))
def test_prescreen_property(vals, a, b, t0, scale, steps, best):
    """Any float32 triangle (edges scaled towards tiny det) and a ray aimed
    near it from t0 away, with best either free or the pair's own t moved by
    ``steps`` float steps: exact Moller-Trumbore accepting at t <= best
    implies survival."""
    x = np.asarray(vals, np.float32)
    v0, e1, e2, d = x[0:3], x[3:6] * np.float32(scale), x[6:9] * np.float32(scale), x[9:12]
    if np.linalg.norm(d) == 0:
        d = np.float32([0, 0, 1])
    d = (d / np.linalg.norm(d)).astype(np.float32)
    o = (v0 + a * e1 + b * e2 - t0 * d).astype(np.float32)
    comps = [torch.tensor([c], dtype=torch.float32)
             for c in (*o, *d, *v0, *e1, *e2)]
    t = moller_trumbore_components(*comps)
    if steps and torch.isfinite(t).all():
        toward = torch.full_like(t, np.inf if steps > 0 else 0.0)
        for _ in range(abs(steps)):
            t = torch.nextafter(t, toward)
        best = float(t)
    check_prescreen(comps, torch.tensor([best], dtype=torch.float32))


def test_visit_floors_order(case):
    """The floors against each other and the plain version's visits: a ray's
    own blocks <= 32 x the warp floor's visits; warp visits between the
    256-group visits and 8 x those; the plain version (groups of 32, no final
    t known) visits at least the warp floor."""
    verts, tris, origins, dirs, kw, t_max = CASES[case["name"]]()
    asset = build_scene_asset(verts, tris, device="cpu", **kw)
    o, d = t_(origins), t_(dirs)
    t, _ = case["slots"]
    t_final = torch.where(torch.isfinite(t), t, torch.full_like(t, culled.t_init_for(t_max)))
    tb = asset.tri_data.shape[2]
    f = culled.visit_floors(o, d, asset.block_lo, asset.block_hi, asset.super_lo,
                            asset.super_hi, asset.super_factor, tb, t_final)
    stats = {}
    culled.raycast_culled_plain(o, d, asset.tri_data, asset.block_lo, asset.block_hi,
                                asset.super_lo, asset.super_hi, asset.super_factor,
                                culled.t_init_for(t_max), stats=stats)
    assert f["per_ray_tests"] <= 32 * tb * f["warp_visits"]
    assert f["group256_visits"] <= f["warp_visits"] <= 8 * f["group256_visits"]
    assert f["warp_visits"] <= stats["block_visits"]
    if case["name"] != "box_t1":
        assert f["per_ray_tests"] > 0
