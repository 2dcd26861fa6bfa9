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
  degrees to the plane: condition 200, the two t differ by 5.4e-6).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu.containers import TriMesh  # noqa: E402
from ipcgen_tpu.ops import raycast as jax_raycast  # noqa: E402
from ipcgen_tpu.ops.raycast_pallas import raycast_pallas_components  # noqa: E402
from ipcgen_tpu.ops.scene_asset import build_scene_asset as jax_build  # noqa: E402
from ipcgen_tpu_torch.ops import _kernels  # noqa: E402
from ipcgen_tpu_torch.ops import raycast_culled as culled  # noqa: E402
from ipcgen_tpu_torch.ops.raycast import raycast_asset  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset  # noqa: E402
from ipcgen_tpu_torch.sim import simulator as port_sim  # noqa: E402

from ipcgen_tpu_torch.utils.synthetic import hardware_scene  # noqa: E402
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
@pytest.mark.parametrize("name, want", sorted(port_sim.RAYCAST_BACKENDS.items()))
def test_config_backend_names(name, want):
    assert port_sim.port_backend(name) == want
    sim = port_sim.S3DISSimulator({"raycast_engine": {"backend": name}}, device="cpu")
    assert sim.backend == want


def test_unknown_config_backend_raises():
    with pytest.raises(ValueError, match="unknown raycast backend"):
        port_sim.port_backend("embree")
    with pytest.raises(ValueError):
        port_sim.S3DISSimulator({"raycast_engine": {"backend": "cuda"}}, device="cpu")


def test_default_config_gives_pairs():
    assert port_sim.load_default_config()["simulation"]["backend"] == "auto"
    assert port_sim.create_simulator_from_config(device="cpu").backend == "pairs"
    assert port_sim.S3DISSimulator({}, device="cpu").backend == "pairs"


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
