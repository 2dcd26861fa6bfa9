"""The three-level pair prepass (csrc/raycast_pairs.cu) in plain torch.

The kernel runs on the card only; tests/test_torch_cuda.py holds it to
``exact_prepass_plain`` there.  These tests check, on the CPU, the two claims
its design rests on (the argument is in the source's header):

- pruning by mega boxes loses no box that a ray enters: a ray that enters a
  box enters the NaN-aware union of any set of boxes holding it
  (``mega_boxes``), with ``_tile_slab_or``'s float32 arithmetic (a
  ``hypothesis`` property), and the plain three-level model
  (``prepass_model``) gives exactly ``exact_prepass_plain``'s four outputs;
- the fast slab form (no NaN checks, no clamps, t_max folded into the exit)
  equals the checked form for finite rays, boxes with no NaN coordinate and
  0 < t_max <= 3e38, bit for bit in its answer; other tiles take the checked
  form.

They also check ``prepass_floors``, the least slab tests that set the
kernel's bound: against a count made one set of rays at a time, and, for
sets of a tile, equal to the model's counts on the blocks with no NaN
coordinate.

Tolerance: none; every comparison is of booleans or integers.
"""

from types import SimpleNamespace

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

torch = pytest.importorskip("torch")
torch.set_num_threads(2)  # six pytest-xdist workers share the CPU cores

from ipcgen_tpu_torch.ops import raycast_pairs as pairs  # noqa: E402
from ipcgen_tpu_torch.ops.scene_asset import build_scene_asset  # noqa: E402

from test_torch_cuda import t_  # noqa: E402
from test_torch_pairs_exact import CASES, scene_rays  # noqa: E402

BIG = 3.0e38


def slab_hits(o, d, lo, hi, t_max):
    """(R, C) bool: ray r enters box c, by ``_tile_slab_or`` (one ray a tile)."""
    return pairs._tile_slab_or(o[:, None, :], d[:, None, :], lo, hi, t_max)


def slab_fast(o, d, lo, hi, t_max):
    """The kernel's fast form (slab_fast): entry from 0, exit from the float
    below t_max, no NaN check and no clamps."""
    tiny = torch.full_like(d, 1e-12)
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d < 0, -tiny, tiny), d)
    t_prev = float(np.nextafter(np.float32(t_max), np.float32(0)))
    entry = torch.zeros(o.shape[0], lo.shape[0])
    exit_ = torch.full((o.shape[0], lo.shape[0]), t_prev)
    for ax in range(3):
        t1 = (lo[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        t2 = (hi[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        entry = torch.fmax(entry, torch.fmin(t1, t2))
        exit_ = torch.fmin(exit_, torch.fmax(t1, t2))
    return entry <= exit_


f32 = st.floats(-50.0, 50.0, width=32)
tiny_or_any = st.one_of(f32, st.sampled_from([0.0, -0.0, 1e-13, -1e-13, 1e-12, -1e-12,
                                              9.99e-13, 3e-39]))


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.lists(f32, min_size=6, max_size=6), min_size=1, max_size=8),
       st.lists(st.booleans(), min_size=8, max_size=8),
       st.lists(f32, min_size=3, max_size=3), st.integers(-1, 47),
       st.lists(tiny_or_any, min_size=3, max_size=3),
       st.sampled_from([float("inf"), 1e30, 25.0, 3.0, 1e-6]))
def test_union_hit_property(corners, nan_box, origin, plane, direction, t_max):
    """A ray that enters a box enters the boxes' NaN-aware union: random
    float32 boxes, some NaN-padded, an origin on one of their slab planes
    (``plane`` >= 0), direction components under 1e-12, finite and infinite
    t_max."""
    c = np.asarray(corners, np.float32)
    lo, hi = np.minimum(c[:, :3], c[:, 3:]), np.maximum(c[:, :3], c[:, 3:])
    nan = np.asarray(nan_box[:len(c)])
    if nan.all():
        nan[0] = False
    lo[nan], hi[nan] = np.nan, np.nan
    o = np.asarray(origin, np.float32)
    if plane >= 0:  # put the origin on a slab plane of some box
        box, ax = (plane // 6) % len(c), plane % 3
        if not nan[box]:
            o[ax] = (lo if plane % 6 < 3 else hi)[box, ax]
    d = np.asarray(direction, np.float32)
    lo_t, hi_t = torch.from_numpy(lo), torch.from_numpy(hi)
    ulo, uhi = pairs.mega_boxes(lo_t, hi_t)
    assert ulo.shape == (1, 3) and not torch.isnan(ulo).any()
    o_t, d_t = torch.from_numpy(o)[None], torch.from_numpy(d)[None]
    hit = slab_hits(o_t, d_t, lo_t, hi_t, t_max)
    union = slab_hits(o_t, d_t, ulo, uhi, t_max)
    assert not hit.any() or union.all()
    if 0 < t_max <= BIG:  # the fast form gives the same answers
        ok = ~torch.isnan(lo_t).any(1)
        assert torch.equal(slab_fast(o_t, d_t, lo_t[ok], hi_t[ok], t_max), hit[:, ok])


def test_fast_form_equals_checked_form():
    """200 rays x 200 boxes of widely spread float32 magnitudes, with tiny
    direction components, origins on slab planes and boxes at 3e38: the two
    forms agree on every pair for t_max from the least positive float32 to
    3e38."""
    rng = np.random.default_rng(0)
    n = 200
    mag = (10.0 ** rng.uniform(-6, 38, (n, 3))).astype(np.float32)
    a = mag * rng.choice([-1, 1], (n, 3)).astype(np.float32)
    b = a + (10.0 ** rng.uniform(-6, 37, (n, 3))).astype(np.float32)
    b = np.where(np.isfinite(b), b, a).astype(np.float32)
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    lo[:4] = [3e38, 3e38, 3e38]
    hi[:4] = [3.4e38, 3.4e38, 3.4e38]
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    o[:50, 0] = lo[:50, 0]  # on slab planes
    o[50:100, 1] = hi[50:100, 1]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::3, 0] = rng.choice([0.0, 1e-13, -1e-13, 1e-12], n)[::3]
    d[::5, 2] = 0.0
    d[::7] = d[::7] * np.float32(1e30)
    o_t, d_t, lo_t, hi_t = map(torch.from_numpy, (o, d, lo, hi))
    for t_max in (float(np.float32(1e-45)), 1e-6, 1.0, 25.0, 1e30, BIG):
        want = slab_hits(o_t, d_t, lo_t, hi_t, t_max)
        assert torch.equal(slab_fast(o_t, d_t, lo_t, hi_t, t_max), want), t_max
    assert slab_hits(o_t, d_t, lo_t, hi_t, 25.0).any()


def test_mega_boxes_are_the_hull_of_the_groups():
    lo = torch.tensor([[0.0, 0, 0], [np.nan] * 3, [2, -1, 5], [1, 1, 1]])
    hi = torch.tensor([[1.0, 1, 1], [np.nan] * 3, [1, 0, 6], [1, 1, 1]])  # row 2 inverted
    mlo, mhi = pairs.mega_boxes(lo, hi)
    assert mlo.tolist() == [[0.0, -1.0, 0.0]] and mhi.tolist() == [[2.0, 1.0, 6.0]]
    lo9 = torch.cat([lo, lo, torch.full((1, 3), np.nan)])
    mlo, _ = pairs.mega_boxes(lo9, lo9)
    assert mlo.shape == (2, 3) and bool(torch.isnan(mlo[1]).all())


def model_vs_plain(o, d, asset, **kw):
    got = pairs.prepass_model(o, d, asset.block_lo, asset.block_hi, **kw)
    want = pairs.exact_prepass_plain(o, d, asset.block_lo, asset.block_hi, **kw)
    for name, g, w in zip(("offsets", "blocks", "groups", "union"), got, want):
        assert torch.equal(g, w), (name, kw)
    return got[4]


# CASES of test_exact_prepass_equals_flat_slab_lists, and the first 499 of
# 512 blocks of 24 triangles: a count that is not a multiple of group x MEGA,
# so the last group and the last mega are partial.
@pytest.mark.parametrize("block_size,tile,group", CASES + [(24, 1024, 4)])
def test_three_level_model_equals_plain(block_size, tile, group):
    verts, tris, origins, dirs = scene_rays()
    asset = build_scene_asset(verts, tris, block_size=block_size, super_factor=2,
                              device="cpu")
    if block_size == 24:
        asset = SimpleNamespace(block_lo=asset.block_lo[:499], block_hi=asset.block_hi[:499])
    nb = asset.block_lo.shape[0]
    assert block_size != 24 or (nb % group and -(-nb // group) % pairs.MEGA)
    o, d = t_(origins), t_(dirs)
    counts = model_vs_plain(o, d, asset, t_max=20.0, group=group, tile=tile,
                            n_sub=tile // 256)
    ng = -(-nb // group)
    assert counts["checked_tiles"] == 0
    assert counts["group_tests"] < ng * o.shape[0]  # the mega level prunes
    floors_vs_model(o, d, asset, t_max=20.0, group=group, tile=tile)


def real_blocks(asset):
    """The asset's block boxes without its NaN padding blocks (at the end)."""
    n_real = int((~torch.isnan(asset.block_lo).any(1)).sum())
    assert not torch.isnan(asset.block_lo[:n_real]).any()
    return asset.block_lo[:n_real], asset.block_hi[:n_real]


def floors_vs_model(o, d, asset, **kw):
    """A tile's rays descending together run the model's tests, but for the
    NaN boxes, which the floors skip: the floors of the asset equal those of
    its real blocks, and at tile level those equal the model's counts on the
    real blocks."""
    floors = pairs.prepass_floors(o, d, asset.block_lo, asset.block_hi, chunk_rays=4096,
                                  **kw)
    lo, hi = real_blocks(asset)
    assert pairs.prepass_floors(o, d, lo, hi, **kw) == floors
    model = pairs.prepass_model(o, d, lo, hi, n_sub=1, **kw)[4]
    assert floors["tile_tests"] == sum(model[k] for k in ("mega_tests", "group_tests",
                                                          "block_tests"))
    assert (floors["tile_tests"] >= floors["subtile_tests"] >= floors["warp32_tests"]
            > floors["per_ray_tests"] > 0)
    return floors


def brute_floor(o, d, block_lo, block_hi, t_max, group, k):
    """prepass_floors' count for sets of ``k`` rays, one set at a time, on
    boxes with no NaN coordinate."""
    glo, ghi = pairs.group_boxes(block_lo, block_hi, group)
    mlo, mhi = pairs.mega_boxes(glo, ghi)
    ng, nb = glo.shape[0], block_lo.shape[0]
    checked = not 0 < t_max <= BIG or not (torch.isfinite(o).all() and torch.isfinite(d).all())
    total = 0
    for s in range(0, o.shape[0], k):
        os_, ds = o[s:s + k], d[s:s + k]
        megas = slab_hits(os_, ds, mlo, mhi, t_max).any(0).tolist()
        groups = slab_hits(os_, ds, glo, ghi, t_max).any(0).tolist()
        tests = 0 if checked else mlo.shape[0]
        for g in range(ng):
            if checked or megas[g // pairs.MEGA]:
                tests += 1
                if groups[g]:
                    tests += min(group, nb - g * group)
        total += tests * k
    return total


@pytest.mark.parametrize("t_max", [20.0, float("inf")])
def test_floors_by_brute_force(t_max):
    """prepass_floors against a count one ray set at a time on the real
    blocks, over chunks of two tiles: the 72-triangle room, 1,024 rays, 18
    real blocks of 24, groups of 2 (9 real groups, 2 megas, the last of one
    group); t_max = inf makes every tile checked."""
    verts, tris, origins, dirs = scene_rays(1024, seed=3, room=False)
    asset = build_scene_asset(verts, tris, block_size=4, super_factor=2, device="cpu")
    o, d = t_(origins), t_(dirs)
    floors = pairs.prepass_floors(o, d, asset.block_lo, asset.block_hi, t_max=t_max,
                                  group=2, tile=256, chunk_rays=512)
    lo, hi = real_blocks(asset)
    assert lo.shape[0] == 18
    for name, k in dict(pairs.FLOOR_RAYS, tile_tests=256).items():
        assert floors[name] == brute_floor(o, d, lo, hi, t_max, 2, k), name


def test_nan_ray_tile_takes_the_checked_path():
    verts, tris, origins, dirs = scene_rays()
    asset = build_scene_asset(verts, tris, block_size=8, super_factor=2, device="cpu")
    o, d = t_(origins).clone(), t_(dirs).clone()
    tile, group = 2048, 8
    kw = dict(group=group, tile=tile, n_sub=8)
    base = model_vs_plain(o, d, asset, t_max=20.0, **kw)
    d[tile + 7, 2] = float("nan")
    o[2 * tile + 1, 0] = float("-inf")
    checked = pairs.checked_tiles(o, d, 20.0, tile)
    assert checked.tolist() == [False, True, True, False]
    counts = model_vs_plain(o, d, asset, t_max=20.0, **kw)
    ng = -(-asset.block_lo.shape[0] // group)
    assert counts["checked_tiles"] == 2
    assert counts["mega_tests"] == base["mega_tests"] // 2
    # A checked tile tests every group and no mega.
    assert counts["group_tests"] >= 2 * ng * tile
    every = model_vs_plain(o, d, asset, t_max=float("inf"), **kw)
    assert every["checked_tiles"] == 4 and every["mega_tests"] == 0
    # The floors descend the same way: a checked tile's rays test every group.
    floors = floors_vs_model(o, d, asset, t_max=20.0, group=group, tile=tile)
    ng_real = -(-real_blocks(asset)[0].shape[0] // group)
    assert floors["per_ray_tests"] >= 2 * ng_real * tile
