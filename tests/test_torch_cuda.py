"""The CUDA kernels on the card, plus the jax-free checks that the CPU parity
tests share (their scenes are in ``ipcgen_tpu_torch/utils/synthetic.py``).

This file imports no jax, so it also runs on the GPU host, which has none:
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` (the repository
conftest imports jax).  Without a card its ``cuda`` tests skip.  Tolerances:

- pair prepass kernel vs its plain version: offsets, blocks, group counts
  and union sizes identical (integers from the same float32 slab
  arithmetic);
- pair kernel vs its plain version: same slot on >= 99.99 % of rays and t
  within 1e-5 relative (the same float32 products, summed in another FMA
  order);
- pair kernel vs the brute oracle on the oblique/degenerate fuzz: the raycast
  contract of tests/test_tpu_hardware.py:234-258 (hit masks agree >= 99 %,
  same triangle >= 99 %, hit-point error p99 <= 5 mm and max <= 5 cm);
- culled kernel vs its plain version and vs the oracle: bit for bit (the
  hardware contract of tests/test_tpu_hardware.py:57-70): every product and
  sum is rounded on its own in all three; its counting instantiation gives
  the same bits and counts at least the per-ray floor
  (``raycast_culled.visit_floors``);
- probe kernels vs their plain versions (``ops/raycast_probe.py``): the
  result modes, grid and flat the same slot on >= 99.99 % of rays and t
  within 1e-5 relative (the same products summed in another order); the
  floor modes bit for bit (their plain versions repeat the kernel's FMA
  order); recip within 1e-6 of the full kernel's t (the same products, only
  the reciprocal differs).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu_torch.ops import raycast_pairs as pairs  # noqa: E402
from ipcgen_tpu_torch.ops import raycast_probe as rp  # noqa: E402
from ipcgen_tpu_torch.ops.raycast import raycast_asset  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset  # noqa: E402
from ipcgen_tpu_torch.utils.synthetic import (  # noqa: E402
    cluttered_room,
    culled_edge_cases,
    hardware_scene,
    patch_ordered_scan_rays,
    synthetic_room,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the raycast kernel has no CPU mode")
    return torch.device("cuda", 0)


def t_(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def t_max_scene():
    """One triangle hit at exactly t = 2 by the first ray, the same triangle
    again in the next leaf block (block_size 1), and a ray that misses."""
    tri = np.array([[0, 0, 2], [4, 0, 2], [0, 4, 2]], np.float32)
    verts = np.concatenate([tri, tri])
    tris = np.arange(6, dtype=np.int32).reshape(2, 3)
    origins = np.array([[1, 1, 0], [10, 10, 0]], np.float32)
    dirs = np.array([[0, 0, 1], [0, 0, 1]], np.float32)
    return verts, tris, origins, dirs


def same_result(a, b):
    """Two RaycastResults equal bit for bit."""
    for name in ("t", "tri_id", "hit", "points", "normals"):
        x, y = getattr(a, name), getattr(b, name)
        assert torch.equal(x, y), (name, int((x != y).sum()))


def contract(hit_a, hit_b, tri_a, tri_b, pts_a, pts_b):
    """The raycast contract of tests/test_tpu_hardware.py:234-258."""
    agree = (hit_a == hit_b).mean()
    assert agree >= 0.99, f"hit agreement {agree}"
    both = hit_a & hit_b
    same = (both & (tri_a == tri_b)).sum() / max(both.sum(), 1)
    assert same >= 0.99, f"same triangle {same}"
    if both.any():
        pe = np.linalg.norm(pts_a[both] - pts_b[both], axis=1)
        assert np.percentile(pe, 99) <= 0.005, np.percentile(pe, 99)
        assert pe.max() <= 0.05, pe.max()


def np_res(res):
    return (res.hit.cpu().numpy(), res.tri_id.cpu().numpy(),
            res.points.cpu().numpy(), res.t.cpu().numpy())


def fuzz_scene(seed):
    """Obliquely rotated cluttered room plus injected slivers, duplicates and
    zero-area triangles, with grazing rays along a rotated wall (the on-chip
    fuzz of tests/test_tpu_hardware.py:175-233)."""
    rng = np.random.default_rng(seed)
    verts, tris = cluttered_room(rng)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q.astype(np.float32) * np.float32(np.sign(np.linalg.det(q)))
    center = verts.mean(axis=0)
    verts = (verts - center) @ q.T + center
    nv = len(verts)
    base = rng.uniform(0.5, 3.0, (24, 3)).astype(np.float32)
    e1 = rng.normal(0, 0.4, (24, 3)).astype(np.float32)
    e2 = rng.normal(0, 0.4, (24, 3)).astype(np.float32)
    e1[0] = 0
    e2[1] = e1[1]
    e1[2] *= 1e-6
    base[3], e1[3], e2[3] = base[4], e1[4], e2[4]
    dverts = np.concatenate([base, base + e1, base + e2]).astype(np.float32)
    dtris = np.arange(72, dtype=np.int32).reshape(3, 24).T + nv
    verts = np.concatenate([verts, dverts]).astype(np.float32)
    tris = np.concatenate([tris, dtris])
    n = 4096
    origins = np.tile(center.astype(np.float32), (n, 1))
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    wall_n = q @ np.array([0, 0, 1], np.float32)
    graze = np.cross(wall_n, rng.normal(size=3)).astype(np.float32)
    dirs[:16] = graze / np.linalg.norm(graze)
    return verts, tris, origins, dirs


def fuzz_check(device, seed):
    """Pair path (kernel on a card, plain version on the CPU) vs the oracle."""
    verts, tris, origins, dirs = fuzz_scene(seed)
    asset = build_scene_asset(verts, tris, device=device)
    o, d = t_(origins).to(device), t_(dirs).to(device)
    rp = raycast_asset(o, d, asset, backend="pairs", t_max=20.0)
    ro = raycast_asset(o, d, asset, backend="brute", t_max=20.0)
    hp, ip, xp, _ = np_res(rp)
    ho, io, xo, _ = np_res(ro)
    contract(hp, ho, ip, io, xp, xo)
    assert np.all(np.isfinite(xp[hp]))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fuzz_oblique_degenerate_kernel(cuda_device, seed):
    from ipcgen_tpu_torch.ops import _kernels

    before = dict(_kernels.LAUNCHES)
    fuzz_check(cuda_device, seed)
    for name in ("raycast_pairs", "raycast_pairs_prepass"):
        assert _kernels.LAUNCHES[name] > before[name]


def incoherent_rays(n: int, seed: int):
    rng = np.random.default_rng(seed)
    origins = rng.uniform([0.5, 0.5, 0.3], [5.5, 4.5, 2.2], (n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins, dirs


@pytest.mark.cuda
@pytest.mark.parametrize("block_size", [8, 128])
def test_prepass_kernel_matches_plain_on_card(cuda_device, block_size):
    """The exact prepass kernel against its plain version, bit for bit, on
    coherent scan rays (2048-, 512- and 256-ray tiles) and sorted incoherent
    rays (1024), at three group sizes; 8 triangles a block gives 6,144 blocks,
    more than one of the kernel's 4,096-block chunks."""
    from ipcgen_tpu_torch.ops import _kernels

    verts, tris = synthetic_room(40_000)
    asset = build_scene_asset(verts, tris, block_size=block_size, device=cuda_device)
    origins, dirs = patch_ordered_scan_rays(1, r=65_536)
    o, d = t_(origins).to(cuda_device), t_(dirs).to(cuda_device)
    cases = [(o, d, 2048, 8), (o, d, 512, 16), (o, d, 256, 32)]
    origins, dirs = incoherent_rays(32_768, seed=6)
    o, d = t_(origins).to(cuda_device), t_(dirs).to(cuda_device)
    order = pairs.ray_sort_order(o, d, pairs._nanmin(asset.block_lo, 0),
                                 pairs._nanmax(asset.block_hi, 0))
    cases.append((o[order].contiguous(), d[order].contiguous(), 1024, 8))
    for o, d, tile, group in cases:
        kw = dict(t_max=25.0, group=group, tile=tile, n_sub=tile // 256)
        before = _kernels.LAUNCHES["raycast_pairs_prepass"]
        got = pairs.exact_prepass(o, d, asset.block_lo, asset.block_hi, **kw)
        assert _kernels.LAUNCHES["raycast_pairs_prepass"] == before + 1
        want = pairs.exact_prepass_plain(o, d, asset.block_lo, asset.block_hi, **kw)
        for name, g, w in zip(("offsets", "blocks", "groups", "union"), got, want):
            assert g.dtype == torch.int32 and torch.equal(g, w), (name, tile, group)
        assert got[1].numel() > 0


def prepass_equal(o, d, asset, **kw):
    """The prepass kernel (and its counting launch) against its plain version
    and the plain three-level model: the four outputs bit for bit, and the
    counting launch's stage counts equal to the model's."""
    from ipcgen_tpu_torch.ops import _kernels

    before = dict(_kernels.LAUNCHES)
    got = pairs.exact_prepass(o, d, asset.block_lo, asset.block_hi, **kw)
    assert _kernels.LAUNCHES["raycast_pairs_prepass"] == before["raycast_pairs_prepass"] + 1
    want = pairs.exact_prepass_plain(o, d, asset.block_lo, asset.block_hi, **kw)
    for name, g, w in zip(("offsets", "blocks", "groups", "union"), got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w), (name, kw)
    glo, ghi = pairs.group_boxes(asset.block_lo, asset.block_hi, kw["group"])
    counted = _kernels.raycast_pairs_prepass_count_cuda(
        o, d, asset.block_lo, asset.block_hi, glo, ghi, kw["group"], kw["t_max"],
        kw["n_sub"])
    assert _kernels.LAUNCHES["raycast_pairs_prepass"] == before["raycast_pairs_prepass"] + 1
    assert (_kernels.LAUNCHES["raycast_pairs_prepass_count"]
            == before["raycast_pairs_prepass_count"] + 1)
    for g, w in zip(counted[:4], want):
        assert torch.equal(g, w), kw
    model = pairs.prepass_model(o, d, asset.block_lo, asset.block_hi, **kw)
    assert counted[4] == model[4], (counted[4], model[4], kw)
    floors = pairs.prepass_floors(o, d, asset.block_lo, asset.block_hi, t_max=kw["t_max"],
                                  group=kw["group"], tile=kw["tile"])
    tests = sum(counted[4][k] for k in ("mega_tests", "group_tests", "block_tests"))
    assert tests >= floors["tile_tests"] >= floors["per_ray_tests"] > 0, (counted[4], floors)
    return counted[4]


@pytest.mark.cuda
@pytest.mark.parametrize("group", [16, 32])
def test_prepass_kernel_on_card_large_groups(cuda_device, group):
    """More than 8,192 blocks (two triangles a block), groups of 16 and 32:
    several of the count pass's chunks, megas of 128 and 256 blocks."""
    verts, tris = synthetic_room(40_000)
    asset = build_scene_asset(verts, tris, block_size=2, device=cuda_device)
    assert asset.num_blocks > 8192
    origins, dirs = patch_ordered_scan_rays(1, r=32_768)
    o, d = t_(origins).to(cuda_device), t_(dirs).to(cuda_device)
    counts = prepass_equal(o, d, asset, t_max=25.0, group=group, tile=2048, n_sub=8)
    assert counts["checked_tiles"] == 0 and counts["mega_tests"] > 0
    p = pairs.prepare_pairs(o, d, asset.tri_data, asset.block_lo, asset.block_hi,
                            t_max=25.0)
    assert p["group"] == 16  # prepare_pairs' own sizing above 8,192 blocks


@pytest.mark.cuda
def test_prepass_kernel_on_card_edge_cases(cuda_device):
    """The culled kernel's edge-case rays (zero direction components, origins
    on slab planes, hits at t_max), padded to whole tiles as prepare_pairs
    pads: at their t_max (fast form), at t_max = inf (every tile checked),
    and with one NaN ray and one infinite origin (those tiles checked)."""
    verts, tris, origins, dirs, kw, t_max = culled_edge_cases()
    asset = build_scene_asset(verts, tris, device=cuda_device, **kw)
    o, d = t_(origins).to(cuda_device), t_(dirs).to(cuda_device)
    tile = 512
    pad = (-o.shape[0]) % tile + tile  # at least two tiles
    o = torch.cat([o, o[-1:].expand(pad, 3)]).contiguous()
    d = torch.cat([d, d[-1:].expand(pad, 3)]).contiguous()
    n_tiles = o.shape[0] // tile
    for group in (1, 4):
        kw = dict(group=group, tile=tile, n_sub=2)
        assert prepass_equal(o, d, asset, t_max=t_max, **kw)["checked_tiles"] == 0
        assert prepass_equal(o, d, asset, t_max=float("inf"), **kw)["checked_tiles"] == n_tiles
        o2, d2 = o.clone(), d.clone()
        d2[3, 1] = float("nan")
        o2[tile + 5, 0] = float("inf")
        assert prepass_equal(o2, d2, asset, t_max=t_max, **kw)["checked_tiles"] == 2


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(cuda_device):
    from ipcgen_tpu_torch.ops import _kernels

    verts, tris = synthetic_room(40_000)
    asset = build_scene_asset(verts, tris, device=cuda_device)
    origins, dirs = incoherent_rays(65_536, seed=5)
    o, d = t_(origins).to(cuda_device), t_(dirs).to(cuda_device)
    comps = (asset.tri_data, asset.block_lo, asset.block_hi)
    cases = [pairs.prepare_pairs(o, d, *comps, t_max=25.0, sort_rays=True)]
    p = pairs.prepare_pairs(o[:4096], d[:4096], *comps, t_max=25.0)
    # Every subtile walks every block: expand_walk_all lists them all.
    p["offsets"], p["blocks"] = pairs.expand_walk_all(
        p["offsets"], p["blocks"], torch.ones(p["offsets"].numel() - 1, dtype=torch.int32,
                                              device=cuda_device), asset.num_blocks)
    cases.append(p)
    for p in cases:
        before = _kernels.LAUNCHES["raycast_pairs"]
        tk, sk = _kernels.raycast_pairs_cuda(p)
        assert _kernels.LAUNCHES["raycast_pairs"] == before + 1
        tp, sp = pairs.raycast_pairs_plain(p)
        same = sk == sp
        assert same.float().mean().item() >= 0.9999
        hit = same & (sk >= 0)
        rel = ((tk - tp).abs() / tp.abs())[hit]
        assert rel.max().item() <= 1e-5


@pytest.mark.cuda
def test_kernel_edge_test_on_card(cuda_device):
    """The shared-edge wall from both sides and the 1 and 10 um graze sets of
    tests/test_torch_pair_edges.py: the kernel hits every wall ray and gives
    the plain version's slot on every ray, t within 1e-5 relative; its
    counting launch gives the same bits and counts float64 decisions on the
    wall, whose rays all lie on edges."""
    from ipcgen_tpu_torch.ops import _kernels
    from test_torch_pair_edges import edge_points, graze_rays, graze_scene, wall

    verts, tris = wall()
    yz = edge_points()
    n = len(yz)
    cases = []
    for sign in (1.0, -1.0):
        o = np.concatenate([np.full((n, 1), 1.0 - sign, np.float32), yz], axis=1)
        d = np.tile(np.array([[sign, 0, 0]], np.float32), (n, 1))
        cases.append(("wall", verts, tris, o, d))
    gv, gt, n_small = graze_scene()
    for delta in (1e-6, 1e-5):
        cases.append(("graze", gv, gt, *graze_rays(gv, gt, n_small, delta, seed=1)))
    for kind, v, t, o, d in cases:
        asset = build_scene_asset(v, t, block_size=32, super_factor=2, device=cuda_device)
        p = pairs.prepare_pairs(t_(o).to(cuda_device), t_(d).to(cuda_device), asset.tri_data,
                                asset.block_lo, asset.block_hi, t_max=20.0)
        tk, sk = _kernels.raycast_pairs_cuda(p)
        n_f64 = torch.zeros(1, dtype=torch.int64, device=cuda_device)
        tc, sc = _kernels.raycast_pairs_cuda(p, f64_count=n_f64)
        tp, sp = pairs.raycast_pairs_plain(p)
        assert torch.equal(sk, sp) and torch.equal(tc, tk) and torch.equal(sc, sk)
        hit = sk >= 0
        assert ((tk - tp).abs() / tp.abs())[hit].max().item() <= 1e-5
        if kind == "wall":
            assert bool(hit[:n].all()) and n_f64.item() > 0


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    from ipcgen_tpu_torch.ops import _kernels

    f = torch.zeros((256, 10), device=cuda_device)
    trif = torch.zeros((1, 10, 640), device=cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    rays = torch.zeros((256, 3), device=cuda_device)
    good = dict(f=f, trif=trif, offsets=torch.zeros(2, **i32), blocks=torch.zeros(0, **i32),
                t_init=1e30, sub=256, origins=rays, dirs=rays,
                tri_data=torch.zeros((1, 16, 128), device=cuda_device),
                radius=torch.zeros(1, device=cuda_device))
    t, s = _kernels.raycast_pairs_cuda(good)
    assert torch.all(s == -1) and torch.all(torch.isinf(t))  # no pairs: every ray misses
    with pytest.raises(TypeError):
        _kernels.raycast_pairs_cuda(dict(good, f=f.double()))
    with pytest.raises(ValueError):
        _kernels.raycast_pairs_cuda(dict(good, f=f.cpu()))
    with pytest.raises(ValueError):
        _kernels.raycast_pairs_cuda(dict(good, f=f[:, :9]))
    with pytest.raises(ValueError):  # one subtile of 128 rays
        _kernels.raycast_pairs_cuda(dict(good, f=f[:128], sub=128))
    with pytest.raises(TypeError):
        _kernels.raycast_pairs_cuda(dict(good, offsets=good["offsets"].long()))
    with pytest.raises(ValueError):  # the raw rays must be one a feature row
        _kernels.raycast_pairs_cuda(dict(good, origins=rays[:128]))
    with pytest.raises(ValueError):  # tri_data of another block size
        _kernels.raycast_pairs_cuda(dict(good, tri_data=good["tri_data"][:, :, :64]))
    with pytest.raises(TypeError):  # the float64 count is one int64
        _kernels.raycast_pairs_cuda(good, f64_count=torch.zeros(1, **i32))


@pytest.mark.cuda
def test_prepass_wrapper_rejects_bad_inputs(cuda_device):
    from ipcgen_tpu_torch.ops import _kernels

    f32 = dict(dtype=torch.float32, device=cuda_device)
    o = torch.zeros((1024, 3), **f32)
    box = torch.zeros((16, 3), **f32)
    gbox = torch.zeros((2, 3), **f32)
    good = (o, o, box, box, gbox, gbox, 8, 25.0, 4)
    offsets, blocks, groups, union = _kernels.raycast_pairs_prepass_cuda(*good)
    assert offsets.shape == (5,) and groups.shape == union.shape == (1,)
    assert blocks.numel() == int(offsets[-1])
    with pytest.raises(TypeError):
        _kernels.raycast_pairs_prepass_cuda(o.double(), *good[1:])
    with pytest.raises(ValueError):
        _kernels.raycast_pairs_prepass_cuda(o.cpu(), *good[1:])
    with pytest.raises(ValueError):  # not whole 1024-ray tiles
        _kernels.raycast_pairs_prepass_cuda(o[:1000], o[:1000], *good[2:])
    with pytest.raises(ValueError):  # 16 blocks of 8 are 2 groups, not 3
        _kernels.raycast_pairs_prepass_cuda(*good[:4], box[:3], box[:3], *good[6:])
    with pytest.raises(ValueError):
        _kernels.raycast_pairs_prepass_cuda(*good[:8], 3)
    with pytest.raises(ValueError):
        _kernels.raycast_pairs_prepass_cuda(*good[:6], 24, *good[7:])


def test_cpu_tensors_never_reach_the_kernel():
    """On the CPU the dispatch takes the plain version: no launch counted."""
    from ipcgen_tpu_torch.ops import _kernels

    before = dict(_kernels.LAUNCHES)
    fuzz_check("cpu", 1)
    assert _kernels.LAUNCHES == before


def culled_cases(device):
    """(label, asset, origins, dirs, t_max) of the culled kernel's card tests."""
    verts, tris, origins, dirs = hardware_scene(8192)
    cases = [("cluttered 8k", build_scene_asset(verts, tris, device=device),
              origins, dirs, 20.0)]
    verts, tris, origins, dirs = t_max_scene()
    asset = build_scene_asset(verts, tris, block_size=1, super_factor=2,
                              device=device)
    cases += [(f"t_max {t}", asset, origins, dirs, t)
              for t in (2.0, float(np.nextafter(np.float32(2), np.float32(3))))]
    verts, tris, origins, dirs, kw, t_max = culled_edge_cases()
    cases.append(("edge cases", build_scene_asset(verts, tris, device=device, **kw),
                  origins, dirs, t_max))
    return cases


@pytest.mark.cuda
def test_culled_kernel_bit_exact_on_card(cuda_device):
    """The culled kernel against its plain version (t, slot) and against the
    oracle (t, tri_id, hit, points, normals), bit for bit."""
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast_culled import raycast_culled_plain, t_init_for

    for label, asset, origins, dirs, t_max in culled_cases(cuda_device):
        o, d = t_(origins).to(cuda_device), t_(dirs).to(cuda_device)
        args = (o, d, asset.tri_data, asset.block_lo, asset.block_hi,
                asset.super_lo, asset.super_hi, asset.super_factor,
                t_init_for(t_max))
        before = _kernels.LAUNCHES["raycast_culled"]
        tk, sk = _kernels.raycast_culled_cuda(*args)
        assert _kernels.LAUNCHES["raycast_culled"] == before + 1
        tp, sp = raycast_culled_plain(*args)
        assert torch.equal(tk, tp) and torch.equal(sk, sp), label
        rk = raycast_asset(o, d, asset, backend="culled", t_max=t_max)
        ro = raycast_asset(o, d, asset, backend="brute", t_max=t_max)
        same_result(rk, ro)
        if label == "t_max 2.0":
            assert not rk.hit[0]  # a hit at exactly t_max is dropped
        elif label.startswith("t_max"):
            # The tie between the two blocks goes to the smaller slot.
            assert rk.hit[0] and rk.t[0].item() == 2.0
            assert rk.tri_id[0].item() == asset.tri_index[0].item()
        else:
            assert 0.5 < rk.hit.float().mean().item() < 1.0


@pytest.mark.cuda
def test_culled_counting_kernel_on_card(cuda_device):
    """The counting instantiation gives the normal kernel's t and slot bit
    for bit and counts at least the per-ray floor's tests and the warp
    floor's visits; it is counted apart from the main kernel."""
    from ipcgen_tpu_torch.ops import _kernels
    from ipcgen_tpu_torch.ops.raycast_culled import t_init_for, visit_floors

    for label, asset, origins, dirs, t_max in culled_cases(cuda_device):
        o, d = t_(origins).to(cuda_device), t_(dirs).to(cuda_device)
        args = (o, d, asset.tri_data, asset.block_lo, asset.block_hi,
                asset.super_lo, asset.super_hi, asset.super_factor, t_init_for(t_max))
        before = dict(_kernels.LAUNCHES)
        tk, sk = _kernels.raycast_culled_cuda(*args)
        tc, sc, counts = _kernels.raycast_culled_count_cuda(*args)
        assert _kernels.LAUNCHES["raycast_culled"] == before["raycast_culled"] + 1
        assert _kernels.LAUNCHES["raycast_culled_count"] == before["raycast_culled_count"] + 1
        assert torch.equal(tk, tc) and torch.equal(sk, sc), label
        tb = asset.tri_data.shape[2]
        t_final = torch.where(sk >= 0, tk, torch.full_like(tk, t_init_for(t_max)))
        floors = visit_floors(o, d, asset.block_lo, asset.block_hi, asset.super_lo,
                              asset.super_hi, asset.super_factor, tb, t_final)
        assert counts["tests"] >= floors["per_ray_tests"], (label, counts, floors)
        assert counts["visits"] >= floors["warp_visits"], (label, counts, floors)
        assert counts["tests"] <= 32 * tb * counts["visits"]
        assert counts["divides"] <= counts["tests"]


@pytest.mark.cuda
def test_culled_wrapper_rejects_bad_inputs(cuda_device):
    from ipcgen_tpu_torch.ops import _kernels

    f32 = dict(dtype=torch.float32, device=cuda_device)
    o = torch.zeros((256, 3), **f32)
    tri = torch.zeros((2, 16, 128), **f32)
    box = torch.zeros((2, 3), **f32)
    sup = torch.zeros((1, 3), **f32)
    good = (o, o, tri, box, box, sup, sup, 2, 1e30)
    _kernels.raycast_culled_cuda(*good)
    with pytest.raises(TypeError):
        _kernels.raycast_culled_cuda(o.double(), *good[1:])
    with pytest.raises(ValueError):
        _kernels.raycast_culled_cuda(o.cpu(), *good[1:])
    with pytest.raises(ValueError):
        _kernels.raycast_culled_cuda(o, o[:, :2].contiguous(), *good[2:])
    with pytest.raises(ValueError):
        _kernels.raycast_culled_cuda(*good[:2], tri[:, :9].contiguous(), *good[3:])
    with pytest.raises(ValueError):  # one super of one block cannot hold two
        _kernels.raycast_culled_cuda(*good[:7], 1, 1e30)


PROBE_CASES = ("lists", "every_seventh_overflowed", "all_overflowed", "counts_0_k_k1")


def probe_case(device, case: str):
    """The probe's inputs on a 9,984-triangle room and 64 tiles of its rays:
    the prepass's lists; every seventh tile, or every tile, walking every
    block (78, in items of ``ITEM_PANELS``); or the lists cut to 0, K and
    K + 1 blocks in turn (K = ``ITEM_PANELS``: no item, one whole item, a
    whole item and one of a single panel; a shorter list keeps its length).
    The cut lists stay the rays' own candidates: on arbitrary blocks most
    hits are near-ties of coplanar triangles, where ``recip``'s approximate
    reciprocal picks the other one."""
    verts, tris = synthetic_room(10_000)
    asset = build_scene_asset(verts, tris, device=device)
    origins, dirs = patch_ordered_scan_rays(2, r=32_768)
    p = rp.prepare_probe(t_(origins).to(device), t_(dirs).to(device), asset.tri_data,
                         asset.block_lo, asset.block_hi)
    if case == "every_seventh_overflowed":
        p["ovf"][::7] = 1
    elif case == "all_overflowed":
        p["ovf"][:] = 1
    elif case == "counts_0_k_k1":
        k, n_tiles = rp.ITEM_PANELS, p["n_tiles"]
        cut = torch.tensor([0, k, k + 1], dtype=torch.int32,
                           device=device)[torch.arange(n_tiles, device=device) % 3]
        p["counts"] = torch.minimum(p["counts"], cut).contiguous()
        p["ovf"] = torch.zeros_like(p["counts"])
        assert all(int((p["counts"] == c).sum()) >= 5 for c in (0, k, k + 1))
    return p


def check_probe(name, kernel, plain):
    got = rp.agreement(*kernel, *plain)
    if name in rp.FLOOR_MODES:
        assert got["bits_equal"], (name, got)
    else:
        assert got["same_slot"] >= 0.9999 and got["max_rel"] <= 1e-5, (name, got)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", PROBE_CASES)
def test_probe_kernels_match_plain_on_card(cuda_device, case):
    from ipcgen_tpu_torch.ops import _kernels

    p = probe_case(cuda_device, case)
    call = (p["f"], p["ids"], p["counts"], p["ovf"])
    outs = {}
    for mode in rp.MODES:
        trif = p["trif_bf16"] if mode == "bf16" else p["trif"]
        before = _kernels.LAUNCHES["raycast_probe_call"]
        outs[mode] = _kernels.raycast_probe_call_cuda(*call, trif, mode, rp.T_INIT)
        assert _kernels.LAUNCHES["raycast_probe_call"] == before + 1
        check_probe(mode, outs[mode], rp.probe_call_plain(*call, trif, mode))
    for mode in ("recip", "recip4"):
        got = rp.agreement(*outs[mode], *outs["full"])
        assert got["same_slot"] >= 0.9999 and got["max_rel"] <= 1e-6, (mode, got)
    if case != "counts_0_k_k1":  # cut lists leave rays without a hit
        assert (outs["full"][1] >= 0).float().mean().item() > 0.9
    ids_flat, counts = rp.grid_ids(p["ids"], p["counts"], 8)
    check_probe("grid8", _kernels.raycast_probe_grid_cuda(p["f"], ids_flat, counts,
                                                          p["trif"], 8, rp.T_INIT),
                rp.probe_grid_plain(p["f"], ids_flat, counts, p["trif"], 8))
    pt, pb = rp.flat_pairs(p["ids"], p["counts"], p["ovf"], p["nb"])
    flat = _kernels.raycast_probe_flat_cuda(p["f"], pt, pb, p["n_tiles"], p["trif"],
                                            rp.T_INIT)
    check_probe("flat", flat, rp.probe_flat_plain(p["f"], pt, pb, p["n_tiles"], p["trif"]))
    got = rp.agreement(*flat, *outs["full"])  # the same walk, other guards
    assert got["same_slot"] >= 0.9999 and got["max_rel"] <= 1e-5, got


@pytest.mark.cuda
def test_probe_wrappers_reject_bad_inputs(cuda_device):
    from ipcgen_tpu_torch.ops import _kernels

    i32 = dict(dtype=torch.int32, device=cuda_device)
    f = torch.zeros((1024, 10), device=cuda_device)
    trif = torch.zeros((1, 10, 640), device=cuda_device)
    ids, counts, ovf = torch.zeros((1, 1), **i32), torch.ones(1, **i32), torch.zeros(1, **i32)
    t, s = _kernels.raycast_probe_call_cuda(f, ids, counts, ovf, trif, "full", 25.0)
    assert torch.all(s == -1) and torch.all(t == 25.0)  # nothing to hit
    with pytest.raises(ValueError):
        _kernels.raycast_probe_call_cuda(f, ids, counts, ovf, trif, "fast", 25.0)
    with pytest.raises(TypeError):  # bf16 mode needs the bf16 panels
        _kernels.raycast_probe_call_cuda(f, ids, counts, ovf, trif, "bf16", 25.0)
    with pytest.raises(ValueError):
        _kernels.raycast_probe_call_cuda(f[:1000], ids, counts, ovf, trif, "full", 25.0)
    with pytest.raises(ValueError):
        _kernels.raycast_probe_grid_cuda(f, ids.view(-1), counts, trif, 2, 25.0)
    with pytest.raises(ValueError):
        _kernels.raycast_probe_flat_cuda(f, ids.view(-1), ids.view(-1)[:0], 1, trif, 25.0)
